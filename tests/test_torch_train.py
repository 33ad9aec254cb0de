"""The port's training slice against the JAX package: LFA masks and counts,
the reconstruct-mode VJP, the autograd function around the MPO-linear
kernels, optimizers and schedules, synthetic data, the train step's
gradients (also with every matmul forced through the kernel mode), and
``Session.finetune`` end to end, from the same weights (drawn by the port,
loaded into both through numpy).

Float32 throughout, summed in another order by two frameworks.  Gradients
and losses agree to ~1e-6 relative (2e-4 allowed, as
``tests/test_kernel_vjp.py`` allows the Pallas kernel against its oracle)
where every matmul runs factorized.  The reconstruct mode's backward rounds
x and dy to bf16 before ``dW = x^T dy`` (the reference's ``_mm_recon_bwd``,
reproduced): an activation that differs in its last f32 bit can round to the
neighbouring bf16 value, so a dW term can differ by one bf16 step, and the
core gradients by 2^-8 of their largest magnitude (9e-4 observed).
After N AdamW steps: Adam's step is ``lr`` times a normalized gradient, so
a 2^-8 relative gradient difference moves it by at most ``lr * 2^-8``
wherever the gradient stands clear of that noise; 99% of the entries are
held to ``N * lr * 2^-8`` (3.9e-5; 2e-5 observed).  Where a gradient entry
is near zero its normalized step can flip sign, so every entry is held only
to ``N * lr``, the most N steps can move it (1.1e-4 observed)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import Session as JSession
from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShape
from repro.core import layers as JL
from repro.core import lightweight as JLW
from repro.core import mpo as JM
from repro.data import pipeline as JData
from repro.models import model as JModel
from repro.models import transformer as JT
from repro.optim import optimizers as JOpt
from repro.optim import schedule as JSched
from repro.train import steps as JSteps
from repro_torch import Session as TSession
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import lightweight as TLW
from repro_torch.core import mpo as TM
from repro_torch.core.carry import load_jax_params
from repro_torch.data import pipeline as TData
from repro_torch.kernels import mpo_linear as TMK
from repro_torch.models import model as TModel
from repro_torch.optim import optimizers as TOpt
from repro_torch.optim import schedule as TSched
from repro_torch.train import loop as TLoop
from repro_torch.train import steps as TSteps

ARCHS = ("bert-base", "qwen3-14b")
TOL = dict(atol=2e-4, rtol=2e-4)
GRAD_TOL = {"factorized": 2e-4, "auto": 2.0 ** -8}    # relative to the leaf's max
STEPS, LR = 5, 2e-3


def _flat(tree, prefix=""):
    """{dotted key path: numpy array} of a nested dict (jax or torch leaves)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.array(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _weights(arch, **cfg_kw):
    """Smoke weights as a numpy tree under the reference's key paths."""
    src = TModel.build(tconfigs.smoke_config(arch, **cfg_kw), seed=7, device="cpu")
    return jax.tree.map(lambda t: np.array(t.detach()), src.tree())


def _pair(arch, **mpo_kw):
    """(reference Session, port Session) over the same smoke weights."""
    tcfg = tconfigs.smoke_config(arch)
    tcfg = dataclasses.replace(tcfg, mpo=dataclasses.replace(tcfg.mpo, **mpo_kw))
    jcfg = jconfigs.smoke_config(arch)
    jcfg = dataclasses.replace(jcfg, mpo=JL.MPOConfig(**dataclasses.asdict(tcfg.mpo)))
    tree = _weights(arch)
    js = JSession(jcfg, jax.tree.map(jnp.asarray, tree))
    ts = TSession.init(tcfg, device="cpu")
    load_jax_params(ts.model, tree)
    return js, ts


def _batch(ts, seq_len=16, batch=4, step=0):
    return ts._default_batch_fn(seq_len, batch, 0)(step)


# --------------------------------------------------------------------------
# LFA masks and counts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["full", "lfa", "central_only"])
def test_masks_and_counts_match_reference(arch, mode):
    tree = _weights(arch)
    jm = _flat(JLW.trainable_mask(jax.tree.map(jnp.asarray, tree), mode=mode))
    params = TModel.build(tconfigs.smoke_config(arch), device="cpu").tree()
    tm = TLW.trainable_mask(params, mode=mode)
    assert {k: bool(v) for k, v in jm.items()} == {k: bool(v) for k, v in
                                                   _flat(tm).items()}
    jc = JLW.count_trainable(tree, JLW.trainable_mask(tree, mode=mode))
    assert TLW.count_trainable(params, tm) == jc
    assert TLW.reduction_savings(params, tm) == pytest.approx(
        JLW.reduction_savings(tree, JLW.trainable_mask(tree, mode=mode)))
    g = TLW.apply_mask_to_grads(TLW.tree_map(torch.ones_like, params), tm)
    assert all(bool(v.all()) == bool(m) and bool(v.any()) == bool(m)
               for v, m in zip(TLW.leaves(g), TLW.leaves(tm)))
    with pytest.raises(ValueError):
        TLW.trainable_mask(params, mode="aux_only")


def test_full_width_bert_base_lfa_counts():
    """The LFA split of full-width bert-base, counted abstractly on both
    sides: 2,629,268 of 7,399,060 parameters train (reduction 0.6446)."""
    jparams, _ = JL.split_annotations(jax.eval_shape(
        JModel.build(jconfigs.get_config("bert-base")).init, jax.random.PRNGKey(0)))
    jc = JLW.count_trainable(jparams, JLW.trainable_mask(jparams, mode="lfa"))
    with torch.device("meta"):
        params = TModel.transformer.init(torch.Generator(),
                                         tconfigs.get_config("bert-base"))
    tc = TLW.count_trainable(params, TLW.trainable_mask(params, mode="lfa"))
    assert tc == jc == (2_629_268, 7_399_060)
    assert round(1 - tc[0] / tc[1], 4) == 0.6446


# --------------------------------------------------------------------------
# reconstruct-mode VJP and the kernel autograd function
# --------------------------------------------------------------------------


def _cores(dims, n, bond, seed=0):
    spec = JM.MPOSpec.make(*dims, n=n, bond_dim=bond)
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.4).astype(np.float32) for s in spec.core_shapes()]


@pytest.mark.parametrize("dims,n,bond,m", [((24, 36), 3, None, 37), ((64, 64), 5, 8, 16),
                                           ((128, 48), 4, 6, 5)])
def test_matmul_reconstruct_grads_match_reference(dims, n, bond, m):
    """The port's custom backward (bf16-cast dW projected through
    ``reconstruct_merged``) against the reference's custom VJP: the same
    bf16 roundings, so the two agree to the f32 tolerance."""
    cores = _cores(dims, n, bond)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((m, dims[0])).astype(np.float32)
    dyw = rng.standard_normal((m, dims[1])).astype(np.float32)
    jg = jax.grad(lambda x, cs: jnp.sum(JM.matmul_reconstruct(x, cs) * dyw),
                  argnums=(0, 1))(jnp.asarray(x), tuple(jnp.asarray(c) for c in cores))
    tx = torch.from_numpy(x).requires_grad_()
    tc = [torch.from_numpy(c).requires_grad_() for c in cores]
    y = TM.matmul_reconstruct(tx, tc)
    (y * torch.from_numpy(dyw)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[0]), **TOL)
    for a, b in zip(tc, jg[1]):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **TOL)
    # the values of reconstruct_merged are reconstruct's
    torch.testing.assert_close(TM.reconstruct_merged([torch.from_numpy(c) for c in cores]),
                               TM.reconstruct([torch.from_numpy(c) for c in cores]))


def test_mpo_linear_fn_gradcheck_and_saved_tensors():
    """``MPOLinearFn`` on the CPU (plain versions inside): float64
    ``gradcheck`` of dx and every dcore, and it saves exactly (cores, x)."""
    cores = [torch.from_numpy(c).double().requires_grad_() for c in _cores((12, 18), 3, 4)]
    x = torch.randn(5, 12, dtype=torch.float64, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    assert torch.autograd.gradcheck(lambda x, *cs: TMK.MPOLinearFn.apply(x, *cs),
                                    (x, *cores), eps=1e-6, atol=1e-8)
    y = TMK.MPOLinearFn.apply(x, *cores)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == len(cores) + 1
    assert all(s.data_ptr() == t.data_ptr() and s.shape == t.shape
               for s, t in zip(saved, (*cores, x)))
    # only what autograd asks for: no dcores when the cores need none
    calls = TMK.mpo_linear_bwd_cores_plain.calls
    xx = x.detach().requires_grad_()
    TMK.MPOLinearFn.apply(xx, *[c.detach() for c in cores]).sum().backward()
    assert TMK.mpo_linear_bwd_cores_plain.calls == calls and xx.grad is not None


# --------------------------------------------------------------------------
# optimizers, schedules, data
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_masked_optimizers_match_reference(name):
    """Three steps of each optimizer under the LFA mask, the same random
    gradients fed to both; frozen leaves hold no state and do not move."""
    tree = _weights("bert-base")
    jmask = JLW.trainable_mask(tree, mode="lfa")
    params = load_jax_params(TModel.build(tconfigs.smoke_config("bert-base"), device="cpu"),
                             tree).tree()
    tmask = TLW.trainable_mask(params, mode="lfa")
    kw = dict(weight_decay=0.01) if name != "sgdm" else {}
    sched = (JSched.cosine_warmup(1e-2, warmup=1, total=3),
             TSched.cosine_warmup(1e-2, warmup=1, total=3))
    jopt = getattr(JOpt, name)(sched[0], mask=jmask, **kw)
    topt = getattr(TOpt, name)(sched[1], mask=tmask, **kw)
    jp = jax.tree.map(jnp.asarray, tree)
    js, ts = jopt.init(jp), topt.init(params)
    rng = np.random.default_rng(3)
    jupdate = jax.jit(jopt.update)
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        jp, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        ts = topt.update(TLW.tree_map(torch.from_numpy, g), ts, params)
    jf, tf = _flat(jp), _flat(params)
    for k in jf:
        np.testing.assert_allclose(tf[k], jf[k], atol=1e-6, rtol=1e-5, err_msg=k)
        if "central" in k:
            np.testing.assert_array_equal(tf[k], _flat(tree)[k])
    frozen = []
    TLW.tree_map(lambda p, s, m: frozen.append(s) if not m else None, params, ts.inner, tmask)
    assert frozen and all(s is None for s in frozen)
    assert ts.step == 3


def test_schedules_match_reference():
    for j, t in ((JSched.constant(3e-4), TSched.constant(3e-4)),
                 (JSched.cosine_warmup(1e-3, warmup=10, total=100, floor=1e-5),
                  TSched.cosine_warmup(1e-3, warmup=10, total=100, floor=1e-5))):
        for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
            assert t(step) == pytest.approx(float(j(step)), rel=1e-6, abs=1e-12)


def test_synthetic_data_bit_identical():
    for step in (0, 3, 1000):
        a = JData.SyntheticCLS(30720, 32, 8, num_classes=2, seed=5).batch(step)
        b = TData.SyntheticCLS(30720, 32, 8, num_classes=2, seed=5).batch(step)
        assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)
        jcfg, tcfg = jconfigs.smoke_config("qwen3-14b"), tconfigs.smoke_config("qwen3-14b")
        a = JData.make_batch_fn(jcfg, JShape("p", "train", 24, 4), 2)(step)
        b = TData.make_batch_fn(tcfg, ShapeConfig("p", "train", 24, 4), 2)(step)
        assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)
    assert TSteps.IGNORE == JSteps.IGNORE


# --------------------------------------------------------------------------
# the train step's gradients
# --------------------------------------------------------------------------


def _port_grads(ts, batch, loss_fn=None):
    """The train step's gradients, caught by an optimizer that records them."""
    seen = []
    opt = TOpt.Optimizer(init=lambda p: TOpt.OptState(0, None),
                         update=lambda g, s, p: seen.append(g) or s)
    step = TSteps.make_train_step(ts.model, opt, loss_fn or ts._default_loss_fn())
    _, metrics = step(TSteps.TrainState(ts.params, opt.init(ts.params)),
                      ts._to_device(batch))
    return _flat(seen[0]), metrics


def _ref_grads(js, batch):
    loss_fn = (JSteps.make_cls_loss(js.cfg) if js.cfg.num_classes
               else (lambda p, b: JSteps.lm_loss(js.model, p, b)))
    b = jax.tree.map(jnp.asarray, batch)
    (_, metrics), g = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, b), has_aux=True))(
        js.params)
    return _flat(g), metrics


def _assert_grads_close(tg, jg, scale_tol):
    assert set(tg) == set(jg)
    for k in jg:
        scale = max(float(np.abs(jg[k]).max()), 1e-12)
        np.testing.assert_allclose(tg[k], jg[k], atol=scale_tol * scale, rtol=scale_tol,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode,freeze", [("factorized", False), ("auto", False),
                                         ("auto", True)])
def test_train_step_grads_match_reference(arch, mode, freeze):
    """Every leaf's gradient (the step differentiates all of them, as
    ``jax.value_and_grad`` does); with ``freeze_central_grads`` the central
    cores' gradients are zero on both sides."""
    js, ts = _pair(arch, mode=mode, freeze_central_grads=freeze)
    batch = _batch(ts)
    tg, tmet = _port_grads(ts, batch)
    jg, jmet = _ref_grads(js, batch)
    _assert_grads_close(tg, jg, GRAD_TOL[mode])
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), **TOL)
    central = [k for k in jg if k.endswith(".central")]
    assert central
    for k in central:
        assert bool(np.any(jg[k])) != freeze
        assert bool(np.any(tg[k])) != freeze


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_mode_train_grads_match_reference(arch):
    """Every MPO matmul forced to ``mode="kernel"``: the reference
    differentiates its Pallas kernels (interpret mode, custom VJP), the port
    runs ``MPOLinearFn`` — on the CPU the plain versions of both kernels,
    including the tied head's transposed cores on the LM."""
    js, ts = _pair(arch, mode="kernel")
    batch = _batch(ts, seq_len=8, batch=2)
    fwd, bwd = TMK.mpo_linear_plain.calls, TMK.mpo_linear_bwd_cores_plain.calls
    tg, _ = _port_grads(ts, batch)
    assert TMK.mpo_linear_plain.calls > fwd and TMK.mpo_linear_bwd_cores_plain.calls > bwd
    jg, _ = _ref_grads(js, batch)
    _assert_grads_close(tg, jg, GRAD_TOL["factorized"])


def test_remat_recomputes_the_same_grads():
    """``cfg.remat`` recomputes each layer in the backward: the gradients
    are the ones without it, bit for bit (the same ops, in the same order)."""
    tree = _weights("bert-base")
    grads = {}
    for remat in (False, True):
        ts = TSession.init("bert-base", device="cpu", remat=remat)
        load_jax_params(ts.model, tree)
        grads[remat], _ = _port_grads(ts, _batch(ts))
    for k in grads[False]:
        np.testing.assert_array_equal(grads[True][k], grads[False][k], err_msg=k)


def test_chunked_lm_loss_matches_reference():
    arch = "qwen3-14b"
    tree = _weights(arch)
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), loss_chunk=4)
    jm = JModel.build(jcfg)
    ts = TSession.init(arch, device="cpu", loss_chunk=4)
    load_jax_params(ts.model, tree)
    batch = _batch(ts)
    jb = jax.tree.map(jnp.asarray, batch)
    (_, jmet), jg = jax.jit(jax.value_and_grad(lambda p: JSteps.lm_loss(jm, p, jb),
                                               has_aux=True))(jax.tree.map(jnp.asarray, tree))
    tg, tmet = _port_grads(ts, batch)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), **TOL)
    assert float(tmet["tokens"]) == float(jmet["tokens"])
    jg = _flat(jg)
    _assert_grads_close(tg, jg, GRAD_TOL["auto"])


# --------------------------------------------------------------------------
# Session.finetune end to end
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def tuned(request):
    """Both sessions after ``finetune(mode="lfa", steps=5)`` from the same
    weights, with their reports and the weights they started from."""
    js, ts = _pair(request.param)
    before = _flat(ts.params)
    ts.serve(3, 16)                               # a snapshot the finetune must drop
    jr = js.finetune(mode="lfa", steps=STEPS, lr=LR, log_every=1)
    tr = ts.finetune(mode="lfa", steps=STEPS, lr=LR, log_every=1)
    return js, ts, jr, tr, before


def test_finetune_history_and_report_match_reference(tuned):
    js, ts, jr, tr, _ = tuned
    assert [h["step"] for h in tr["history"]] == list(range(1, STEPS + 1))
    for jh, th in zip(jr["history"], tr["history"]):
        assert set(th) == set(jh)
        for k in jh:
            np.testing.assert_allclose(th[k], jh[k], rtol=2e-4, atol=1e-6, err_msg=k)
    for k in ("mode", "steps", "total", "trainable"):
        assert tr[k] == jr[k], k
    assert tr["reduction"] == pytest.approx(jr["reduction"])
    assert tr["loss_first"] == pytest.approx(jr["loss_first"], rel=2e-4)
    assert tr["loss_final"] == pytest.approx(jr["loss_final"], rel=2e-4)
    rep, jrep = ts.report(), js.report()
    assert rep["stage"] == "finetune" and rep["weights_version"] == 1
    assert rep["trainable"] == jrep["trainable"]
    assert rep["trainable_reduction"] == pytest.approx(jrep["trainable_reduction"])


def test_finetune_params_match_reference_and_central_is_frozen(tuned):
    js, ts, _, _, before = tuned
    jf, tf = _flat(js.params), _flat(ts.params)
    moved = 0
    for k in jf:
        if k.endswith(".central"):
            np.testing.assert_array_equal(tf[k], before[k], err_msg=k)
            np.testing.assert_array_equal(jf[k], before[k], err_msg=k)
            continue
        diff = np.abs(tf[k] - jf[k])
        assert diff.max() <= LR * STEPS, k
        assert np.quantile(diff, 0.99) <= STEPS * LR * 2.0 ** -8, k
        moved += int(not np.array_equal(tf[k], before[k]))
    assert moved > 0


def test_serve_after_finetune_matches_reference(tuned):
    """The finetune dropped the pre-finetune snapshot: ``serve()`` densifies
    the tuned cores, and greedy tokens equal the reference's after its
    finetune."""
    js, ts, _, _, _ = tuned
    prompts = np.random.default_rng(0).integers(0, ts.cfg.vocab_size, (3, 7)).astype(np.int32)
    h = ts.serve(3, 16)
    assert h.version == ts.weights_version == 1
    tt = h.generate({"tokens": prompts}, 6).numpy()
    jt = np.asarray(js.serve(3, 16).generate({"tokens": jnp.asarray(prompts)}, 6))
    np.testing.assert_array_equal(tt, jt)


def test_evaluate_matches_reference(tuned):
    js, ts, _, _, _ = tuned
    kw = dict(num_batches=2, seq_len=16, batch_size=4)
    assert ts.evaluate(**kw) == pytest.approx(js.evaluate(**kw), rel=2e-4, abs=1e-6)


def test_finetune_options_and_what_is_not_ported():
    ts = TSession.init("bert-base", device="cpu")
    rep = ts.finetune(mode="full", steps=2, warmup=1, seq_len=16, batch_size=4,
                      weight_decay=0.01, donate=True, log_every=1)
    assert rep["reduction"] == 0.0 and len(rep["history"]) == 2
    # a caller-supplied optimizer owns its masking: no trainable counts
    rep = ts.finetune(steps=1, seq_len=16, batch_size=4,
                      optimizer=TOpt.sgdm(1e-3), log_every=1)
    assert "trainable" not in rep
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        ts.finetune(steps=1, ckpt_dir="/nonexistent")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        TLoop.run_training(None, None, None, TLoop.LoopConfig(steps=1, ckpt_dir="x"))


def test_forward_cls_matches_reference():
    tree = _weights("bert-base")
    ts = TSession.init("bert-base", device="cpu")
    load_jax_params(ts.model, tree)
    batch = _batch(ts)
    jl, _ = JT.forward_cls(jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch),
                           jconfigs.smoke_config("bert-base"))
    with torch.no_grad():
        tl = TModel.transformer.forward_cls(ts.params, ts._to_device(batch), ts.cfg)
    assert tuple(tl.shape) == (4, 2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
