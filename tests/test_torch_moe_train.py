"""Fine-tuning the port's moe family against the JAX package: the cores
backward over an expert stack (``kernels.mpo_linear``), ``MPOLinearFn`` and
``apply_moe`` differentiated, two LFA steps of both smoke configurations,
the refusals both packages share (Algorithm 1 and 2 over expert stacks),
and persistence.  Inputs are drawn with numpy from a seed; the smoke weights
are drawn by the port and loaded into both packages.

Tolerances:
- float32 gradients summed in another order, by the other framework or by
  the stacked call against one matrix's: 2e-5 of each gradient's largest
  magnitude (``tests/test_torch_bwd_plan.py``'s); the stacked plain version
  against each matrix run alone: bit for bit (the same function, one matrix
  at a time).
- ``apply_moe``'s gradients, every matmul in float32 (the kernel or the
  factorized mode: not the reconstruct mode, whose backward rounds x and dy
  to bf16): 2e-4 of each gradient's largest magnitude, as
  ``tests/test_torch_train.py`` holds float32 gradients.
- Two AdamW steps: ``tests/test_torch_train.py``'s rule — losses and aux
  within 2e-4 relative, every parameter within ``steps * lr`` and 99% of
  each leaf within ``steps * lr * 2^-8``, every matmul factorized.  The
  smoke matrices' default plan is the reconstruct mode, whose backward
  rounds x and dy to bf16 before ``dW = x^T dy`` (the reference's
  ``_mm_recon_bwd``, reproduced): a term moves by a bf16 step where an
  activation differs in its last float32 bit (~2e-3 of an expert core's
  gradient seen), which two Adam steps amplify at small gradients past the
  rule above; that backward over an expert stack is held to the
  reference's one call at a time, where x and dy are the same bits.
- Persistence: bit for bit (the same computation on the same bits).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import Session as JSession
from repro import configs as jconfigs
from repro.core import convert as JConvert
from repro.core import layers as JL
from repro.core import mpo as JM
from repro.core import squeeze as JSQ
from repro.kernels.mpo_linear import mpo_linear as j_mpo_linear
from repro.models import model as JModel
from repro.models import moe as JMOE
from repro_torch import Session as TSession
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import convert as TConvert
from repro_torch.core import mpo as TM
from repro_torch.core import squeeze as TSQ
from repro_torch.core.carry import load_jax_params
from repro_torch.core.lightweight import leaves
from repro_torch.kernels import mpo_linear as TMK
from repro_torch.models import model as TModel
from repro_torch.models import moe as TMOE
from repro_torch.resilience import faults

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

ARCHS = ("phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b")
TOL = 2e-5
METRIC_TOL = 2e-4
STEPS, LR, SEQ, BATCH = 2, 2e-3, 16, 4
# (experts, (I, J), cores, bond, rows an expert): one of tests/test_kernel_vjp.py's shapes
STACKS = [(3, (64, 64), 5, 8, 5)]


def _stack_inputs(e, dims, n, bond, m, seed=0):
    spec = JM.MPOSpec.make(*dims, n=n, bond_dim=bond)
    rng = np.random.default_rng(seed)
    sigma = (1.0 / dims[0] / math.prod(spec.bonds())) ** (1.0 / (2 * n))
    cores = [(rng.standard_normal((e,) + s) * sigma).astype(np.float32)
             for s in spec.core_shapes()]
    x = rng.standard_normal((e, m, dims[0])).astype(np.float32)
    dy = rng.standard_normal((e, m, dims[1])).astype(np.float32)
    return cores, x, dy


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), what


# --------------------------------------------------------------------------
# the cores backward over a stack
# --------------------------------------------------------------------------


@pytest.mark.parametrize("e,dims,n,bond,m", STACKS)
def test_plain_bwd_over_a_stack_matches_each_matrix_and_jax(e, dims, n, bond, m):
    """``mpo_linear_bwd_cores_plain`` over (E, d0, i, j, d1) cores: each
    expert's gradients bit-equal to its matrix's call, within ``TOL`` of
    ``jax.grad`` of ``jax.vmap`` of the reference's ``mpo_linear`` (its
    Pallas kernels in interpret mode: the custom VJP batched over the
    experts, as ``repro/models/moe.py`` runs it); the central core skipped
    leaves the others' bits; an expert whose rows are all zero (capacity
    padding) gets exact zeros."""
    cores, x, dy = _stack_inputs(e, dims, n, bond, m)
    x[-1], dy[-1] = 0.0, 0.0
    tc = [torch.from_numpy(c) for c in cores]
    tx, tdy = torch.from_numpy(x), torch.from_numpy(dy)
    got = TMK.mpo_linear_bwd_cores_plain(tc, tx, tdy)
    for k in range(e):
        alone = TMK.mpo_linear_bwd_cores_plain([c[k] for c in tc], tx[k], tdy[k])
        assert all(torch.equal(g[k], a) for g, a in zip(got, alone)), k
    assert all(torch.equal(g[-1], torch.zeros_like(g[-1])) for g in got)
    jc = tuple(jnp.asarray(c) for c in cores)
    grad = jax.jit(jax.grad(lambda cs: jnp.sum(jax.vmap(
        lambda c, xx: j_mpo_linear(list(c), xx, interpret=True))(cs, jnp.asarray(x)) * dy)))(jc)
    for k, (g, r) in enumerate(zip(got, grad)):
        _close(g.numpy(), r, what=k)
    central = n // 2
    some = TMK.mpo_linear_bwd_cores_plain(tc, tx, tdy, [k != central for k in range(n)])
    assert some[central] is None
    assert all(torch.equal(a, b) for k, (a, b) in enumerate(zip(some, got)) if k != central)


def test_mpo_linear_fn_over_a_stack_matches_vmapped_autograd():
    """``MPOLinearFn`` over a stack on the CPU (its plain versions; the same
    path the card runs through the kernels) against autograd of
    ``torch.vmap(apply_mpo)``: y, dL/dx and every core's gradient."""
    cores, x, dy = _stack_inputs(3, (64, 64), 5, 8, 6, seed=1)
    a = [torch.from_numpy(c).requires_grad_() for c in cores]
    b = [torch.from_numpy(c).requires_grad_() for c in cores]
    xa, xb = (torch.from_numpy(x).requires_grad_() for _ in range(2))
    ya = TMK.MPOLinearFn.apply(xa, 0, *a)
    yb = torch.vmap(TM.apply_mpo)(b, xb)
    _close(ya.detach(), yb.detach())
    ga = torch.autograd.grad(ya, [xa, *a], torch.from_numpy(dy))
    gb = torch.autograd.grad(yb, [xb, *b], torch.from_numpy(dy))
    for k, (p, q) in enumerate(zip(ga, gb)):
        _close(p, q, what=k)


def test_stacked_reconstruct_vjp_matches_vmapped_reference():
    """``mpo.matmul_reconstruct`` over a stack (the reconstruct mode of an
    expert stack) against ``jax.vmap`` of the reference's custom VJP: y and
    dL/dx within ``TOL``, each expert's core gradients (dW from bf16 x and dy
    on both sides) within ``TOL`` and bit-equal to its matrix's call."""
    cores, x, dy = _stack_inputs(3, (64, 48), 4, 6, 5, seed=2)
    tc = [torch.from_numpy(c).requires_grad_() for c in cores]
    tx = torch.from_numpy(x).requires_grad_()
    y = TM.matmul_reconstruct(tx, tc)
    got = torch.autograd.grad(y, [tx, *tc], torch.from_numpy(dy))
    jy, vjp = jax.vjp(jax.vmap(lambda xx, *cs: JM.matmul_reconstruct(xx, list(cs))),
                      jnp.asarray(x), *[jnp.asarray(c) for c in cores])
    _close(y.detach(), jy)
    for k, (g, r) in enumerate(zip(got, vjp(jnp.asarray(dy)))):
        _close(g, r, what=k)
    for e in range(3):
        cs = [torch.from_numpy(c[e]).requires_grad_() for c in cores]
        xe = torch.from_numpy(x[e]).requires_grad_()
        alone = torch.autograd.grad(TM.matmul_reconstruct(xe, cs), [xe, *cs],
                                    torch.from_numpy(dy[e]))
        assert all(torch.equal(g[e], a) for g, a in zip(got, alone)), e


# --------------------------------------------------------------------------
# apply_moe's gradients
# --------------------------------------------------------------------------


def _jcfg(tcfg):
    return JL.MPOConfig(**dataclasses.asdict(tcfg))


def test_apply_moe_gradients_match_reference():
    """The gradients of ``sum(w * y) + aux`` of one MoE layer (2 x 16
    tokens, capacity binding at factor 0.5) with respect to the router, every
    expert core and x, against ``jax.grad`` of the reference's
    ``apply_moe``: the softmax gates and the combine einsum carry them,
    ``top_k`` and the capacity positions carry none.  Smoke phi3.5-moe
    (top-2), every expert matrix in the kernel mode (``MPOLinearFn`` over
    the stack, the path the card runs; the reference's Pallas kernels in
    interpret mode); top-1 routing is held by the LFA steps below."""
    cfg = tconfigs.smoke_config(ARCHS[0])
    cfg = dataclasses.replace(cfg, mpo=dataclasses.replace(cfg.mpo, mode="kernel"))
    tp = TMOE.init_moe(torch.Generator().manual_seed(3), cfg.d_model, cfg.d_ff,
                       cfg.num_experts, cfg.mlp_act, cfg.mpo)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    kw = dict(act=cfg.mlp_act, top_k=cfg.top_k, capacity_factor=0.5, phase="train")

    def jloss(p, xx):
        y, aux = JMOE.apply_moe(p, xx, mpo=_jcfg(cfg.mpo), **kw)
        return jnp.sum(y * w) + aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    flat = list(leaves(tp))
    for t in flat:
        t.requires_grad_()
    y, aux = TMOE.apply_moe(tp, tx, mpo=cfg.mpo, **kw)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux, [tx, *flat])
    _close(got[0], jgx, METRIC_TOL, "x")
    names = [".".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    for name, g, r in zip(names, got[1:], jax.tree.leaves(jg), strict=True):
        _close(g, r, METRIC_TOL, name)
        assert float(np.abs(np.asarray(r)).max()) > 0, name


# --------------------------------------------------------------------------
# Session.finetune on the smoke configurations
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """Smoke weights drawn by the port as numpy, their tree checked against
    the reference's abstract one (key paths, shapes, dtypes)."""
    src = TModel.build(tconfigs.smoke_config(arch), seed=7, device="cpu")
    tree = jax.tree.map(np.array, src.tree())
    abstract, _ = JL.split_annotations(jax.eval_shape(
        JModel.build(jconfigs.smoke_config(arch)).init, jax.random.PRNGKey(0)))
    assert jax.tree.structure(abstract) == jax.tree.structure(tree)
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in
               zip(jax.tree.leaves(abstract), jax.tree.leaves(tree)))
    return tree


def _sessions(arch, mode="auto"):
    tree = _weights(arch)
    jcfg = jconfigs.smoke_config(arch)
    js = JSession(dataclasses.replace(jcfg, mpo=dataclasses.replace(jcfg.mpo, mode=mode)),
                  jax.tree.map(jnp.asarray, tree))
    tcfg = tconfigs.smoke_config(arch)
    ts = TSession.init(dataclasses.replace(tcfg, mpo=dataclasses.replace(tcfg.mpo, mode=mode)),
                       device="cpu")
    load_jax_params(ts.model, tree)
    return js, ts


def _flat(params) -> dict:
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.fixture(scope="module", params=ARCHS)
def tuned(request):
    js, ts = _sessions(request.param, mode="factorized")
    before = _flat(jax.tree.map(np.asarray, js.params))
    kw = dict(steps=STEPS, lr=LR, seq_len=SEQ, batch_size=BATCH, log_every=1)
    jr = js.finetune(**kw)
    tr = ts.finetune(**kw)
    return js, ts, jr, tr, before


def test_lfa_steps_match_reference(tuned):
    """Two LFA steps: losses, ``aux`` and the gradient norm each step, the
    trainable and total counts (25,440 of 34,656 in both configurations),
    every updated leaf; the central cores (the experts' too) unchanged."""
    js, ts, jr, tr, before = tuned
    assert (tr["trainable"], tr["total"]) == (jr["trainable"], jr["total"]) == (25_440, 34_656)
    for jh, th in zip(jr["history"], tr["history"], strict=True):
        assert set(th) == set(jh) and th["aux"] > 0
        for k in ("loss", "aux", "grad_norm"):
            assert th[k] == pytest.approx(jh[k], rel=METRIC_TOL), k
    jf = _flat(jax.tree.map(np.asarray, js.params))
    tf = {k: v.detach().numpy() for k, v in ts.model.state_dict().items()}
    assert jf.keys() == tf.keys()
    moved = 0
    for k in jf:
        if k.endswith(".central"):
            np.testing.assert_array_equal(tf[k], before[k], err_msg=k)
            continue
        diff = np.abs(tf[k] - jf[k])
        assert diff.max() <= LR * STEPS, k
        assert np.quantile(diff, 0.99) <= STEPS * LR * 2.0 ** -8, k
        moved += "experts" in k and not np.array_equal(tf[k], before[k])
    assert moved > 0


# --------------------------------------------------------------------------
# what both packages refuse: Algorithm 1 and 2 over (L, E) expert stacks
# --------------------------------------------------------------------------


def test_moe_conversion_and_squeeze_are_refused_as_in_the_reference():
    """The reference's ``convert_dense_to_mpo`` takes only (L, I, J) stacks
    (``repro/core/convert.py:56``) and ``squeeze_once`` only 5-D cores
    (``repro/core/squeeze.py:69-77``): on the smoke phi3.5-moe tree both
    raise.  The port refuses the same, naming those limits, in
    ``Session.from_dense`` / ``Session.squeeze`` and in the algorithms."""
    arch = ARCHS[0]
    cfg = tconfigs.smoke_config(arch)
    tdense = TModel.build(dataclasses.replace(cfg, mpo=dataclasses.replace(
        cfg.mpo, enabled=False)), seed=5, device="cpu").tree()
    # the reference's calls on the MoE layers alone: the rest of the tree
    # converts and squeezes, and would only add time before the raise
    moe = lambda tree: {"layers": {"moe": tree["layers"]["moe"]}}
    dense = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), moe(tdense))
    tree = jax.tree.map(jnp.asarray, moe(_weights(arch)))
    assert dense["layers"]["moe"]["experts"]["w_up"]["w"].ndim == 4      # (L, E, I, J)
    with pytest.raises(ValueError, match="!= spec"):
        JConvert.convert_dense_to_mpo(dense, tree)
    with pytest.raises(ValueError, match="subscript"):
        JSQ.squeeze_once(tree)
    ts = TSession.init(arch, device="cpu")
    for call in (lambda: TSession.from_dense(tdense, ts.cfg, device="cpu"),
                 lambda: ts.squeeze(max_iters=1),
                 lambda: TConvert.convert_dense_to_mpo(tdense, ts.params),
                 lambda: TSQ.squeeze_once(ts.params)):
        with pytest.raises(NotImplementedError, match="repro/core/(convert|squeeze).py"):
            call()


# --------------------------------------------------------------------------
# persistence
# --------------------------------------------------------------------------


def test_moe_finetune_resumes_bit_for_bit(tmp_path):
    """smoke phi3.5-moe preempted at step 2 of 4 and resumed: the final
    checkpoints (6-D expert cores, AdamW state) and parameters bit-equal to
    an uninterrupted run's."""
    kw = dict(steps=4, seq_len=8, batch_size=2, ckpt_every=100)
    ref = TSession.init(ARCHS[0], device="cpu")
    ref.finetune(ckpt_dir=str(tmp_path / "ref"), **kw)
    s = TSession.init(ARCHS[0], device="cpu")
    ck = str(tmp_path / "ck")
    with faults.fault_scope(faults.FaultPlan(preempt_finetune_step=2)):
        with pytest.raises(faults.Preemption):
            s.finetune(ckpt_dir=ck, **kw)
    assert CheckpointManager(ck).latest_step() == 2
    s.finetune(ckpt_dir=ck, **kw)
    a, b = ref.model.state_dict(), s.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    with np.load(f"{ck}/step_4/arrays.npz") as got, \
            np.load(tmp_path / "ref/step_4/arrays.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        assert any(got[k].ndim == 6 for k in got.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_moe_sessions_restore_across_packages(tuned, tmp_path):
    """A fine-tuned moe session saved by either package restores in the
    other: every leaf (6-D expert cores) bit-equal, stage, version, mask."""
    js, ts, _, _, _ = tuned
    r = JSession.restore(ts.save(str(tmp_path / "port")))
    for a, b in zip(jax.tree.leaves(r.params), leaves(ts.params), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (r.stage, r.weights_version) == (ts.stage, ts.weights_version)
    assert [bool(m) for m in jax.tree.leaves(r.mask)] == list(leaves(ts.mask))
    t = TSession.restore(js.save(str(tmp_path / "ref")), device="cpu")
    for a, b in zip(leaves(t.params), jax.tree.leaves(js.params), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (t.stage, t.weights_version) == (js.stage, js.weights_version)
    assert list(leaves(t.mask)) == [bool(m) for m in jax.tree.leaves(js.mask)]


@pytest.mark.parametrize("arch,layers,counts", [
    ("phi3.5-moe-42b-a6.6b", 2, (71_466_048, 105_217_088)),
    ("llava-next-34b", 2, (15_320_900, 28_559_172))])
def test_full_width_lfa_counts_match_reference(arch, layers, counts):
    """The LFA split ``chip_smoke.py`` phase 13 holds full-width phi3.5-moe
    and llava-next-34b to at its depths (``PHI35_TRAIN_LAYERS``,
    ``LLAVA_TRAIN_LAYERS``), abstractly in both packages (meta tensors,
    ``jax.eval_shape``): the reference's count."""
    from repro.core import lightweight as JLW
    from repro_torch.core import lightweight as TLW
    from repro_torch.models import transformer as TR
    with torch.device("meta"):
        params = TR.init(torch.Generator(), tconfigs.get_config(arch, num_layers=layers))
    jparams, _ = JL.split_annotations(jax.eval_shape(
        JModel.build(jconfigs.get_config(arch, num_layers=layers)).init, jax.random.PRNGKey(0)))
    assert TLW.count_trainable(params, TLW.trainable_mask(params, mode="lfa")) == \
        JLW.count_trainable(jparams, JLW.trainable_mask(jparams, mode="lfa")) == counts
