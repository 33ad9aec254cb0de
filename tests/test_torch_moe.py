"""The port's MoE family (``repro_torch.models.moe``, the expert-stacked
``MPOEngine.linear`` and the moe branch of ``models.transformer``) against
the JAX package, on inputs drawn with numpy from a seed and the same weights
in both (``core.carry.load_jax_params``).

Tolerances, each the sum of two frameworks' roundings in another order:
- float32: 1e-5 of the largest magnitude for one MoE layer and one stacked
  matmul (~1e-7 seen), 1e-4 for the logits of the 2-layer smoke models (as
  ``test_torch_model.py``); greedy tokens identical.
- bfloat16 (one MoE layer, one stacked matmul): 2^-7 of the largest
  magnitude, two bf16 steps: each expert matmul's output is one rounding of
  an f32 sum, which the other order can move by one step, and the gated
  product and the combine add one more.
- The aux loss and the routing (which rows each expert drops) are computed
  in f32 from the same inputs: aux within 1e-6, dropped rows identical.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import Session as JSession
from repro import configs as jconfigs
from repro.core import engine as JE
from repro.core import layers as JL
from repro.models import model as JModel
from repro.models import moe as JMOE
from repro_torch import Session as TSession
from repro_torch import configs as tconfigs
from repro_torch.core import engine as TE
from repro_torch.core import layers as TL
from repro_torch.core import mpo as TM
from repro_torch.core.carry import load_jax_params
from repro_torch.kernels import mpo_linear as TMK
from repro_torch.models import model as TModel
from repro_torch.models import moe as TMOE

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

ARCHS = ("phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b")
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
MODEL_TOL = 1e-4


def _jcfg(tcfg):
    return JL.MPOConfig(**dataclasses.asdict(tcfg))


def _close(got: torch.Tensor, want, dtype: str, what=""):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= TOL[dtype] * np.abs(want).max(), (what, err, np.abs(want).max())


# --------------------------------------------------------------------------
# one MoE layer
# --------------------------------------------------------------------------


def _moe_params(arch, seed=3):
    """A smoke config's MoE layer, drawn by the port: (cfg, torch params,
    the same as jnp arrays)."""
    cfg = tconfigs.smoke_config(arch)
    tp = TMOE.init_moe(torch.Generator().manual_seed(seed), cfg.d_model, cfg.d_ff,
                       cfg.num_experts, cfg.mlp_act, cfg.mpo)
    return cfg, tp, jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_apply_moe_matches_reference(arch, dtype, capacity_factor):
    """y and aux for 2 x 16 tokens; at capacity_factor 0.25 (cap = 4 of a
    16-token row's 16 or 32 claims) tokens are dropped, and the same rows
    come out zero in both.  Row 0 of the batch is all zeros, so every one
    of its router logits ties: the lower expert index must win, as
    ``jax.lax.top_k`` picks it."""
    cfg, tp, jp = _moe_params(arch)
    x = np.random.default_rng(0).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    x[0, :4] = 0.0
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    kw = dict(act=cfg.mlp_act, top_k=cfg.top_k, capacity_factor=capacity_factor,
              phase="prefill")
    jy, jaux = JMOE.apply_moe(jp, jx, mpo=_jcfg(cfg.mpo), **kw)
    with torch.no_grad():
        ty, taux = TMOE.apply_moe(tp, tx, mpo=cfg.mpo, **kw)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    _close(ty, jnp.asarray(jy, jnp.float32), dtype, "y")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    dropped_t = (ty.float().abs().sum(-1) == 0).numpy()
    dropped_j = np.asarray(jnp.abs(jnp.asarray(jy, jnp.float32)).sum(-1) == 0)
    np.testing.assert_array_equal(dropped_t, dropped_j)
    if capacity_factor < 1:
        assert dropped_t[1].any()               # capacity binds: whole tokens dropped


def test_stable_top_k_breaks_ties_like_lax_top_k():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1], [0.3, 0.1, 0.3, 0.3]],
                     np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = TMOE.stable_top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# --------------------------------------------------------------------------
# the expert-stacked matmul
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["auto", "factorized", "reconstruct", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_linear_matches_vmapped_reference(mode, dtype):
    """``engine.linear`` over (E, d0, i, j, d1) cores and x (E, N, I)
    against ``jax.vmap`` of the reference's ``linear`` over the experts (its
    Pallas kernel in interpret mode under ``mode="kernel"``, the port's
    plain version there); the kernel mode is one plain-version call for the
    whole stack."""
    cfg = TL.MPOConfig(n=4, bond_ffn=8, mode=mode)
    e, n, i_dim, j_dim = 3, 6, 48, 96
    gen = torch.Generator().manual_seed(0)
    lin = {"cores": {k: torch.stack([v] + [TL.init_linear(gen, i_dim, j_dim, cfg=cfg)["cores"][k]
                                           for _ in range(e - 1)])
                     for k, v in TL.init_linear(gen, i_dim, j_dim, cfg=cfg)["cores"].items()}}
    x = np.random.default_rng(1).normal(size=(e, n, i_dim)).astype(np.float32)
    jlin = jax.tree.map(lambda t: jnp.asarray(t.numpy()), lin)
    jeng = JE.engine_for(_jcfg(cfg))
    jy = jax.vmap(lambda p, h: jeng.linear(p, h, phase="prefill"))(
        jlin, jnp.asarray(x).astype(dtype))
    calls = TMK.mpo_linear_plain.calls
    ty = TE.engine_for(cfg).linear(lin, torch.from_numpy(x).to(getattr(torch, dtype)),
                                   phase="prefill")
    assert TMK.mpo_linear_plain.calls == calls + (mode == "kernel")
    assert ty.shape == (e, n, j_dim) and ty.dtype == getattr(torch, dtype)
    _close(ty, jnp.asarray(jy, jnp.float32), dtype, mode)


def test_stacked_helpers_equal_the_per_matrix_ones():
    """The engine's factorized chain and the plain version over a stack
    equal the unstacked functions matrix by matrix, bit for bit."""
    gen = torch.Generator().manual_seed(2)
    cores = [torch.randn(s, generator=gen) for s in
             [(3, 1, 4, 3, 5), (3, 5, 2, 4, 6), (3, 6, 6, 2, 1)]]
    x = torch.randn(3, 2, 5, 48, generator=gen)
    eng = TE.engine_for(TL.MPOConfig(n=3, mode="factorized"))
    ys = eng.linear({"cores": TL.cores_from_list(cores)}, x, phase="prefill")
    yp = TMK.mpo_linear_plain(cores, x)
    assert ys.shape == yp.shape == (3, 2, 5, 24)
    for k in range(3):
        per = [c[k] for c in cores]
        assert torch.equal(ys[k], TM.apply_mpo(per, x[k]))
        assert torch.equal(yp[k], TMK.mpo_linear_plain(per, x[k]))
    assert torch.equal(TM.transpose_cores(cores)[1][2], TM.transpose_cores([cores[1][2]])[0])


def test_stacked_kernel_mode_refuses_a_backward():
    """The kernel mode over a stack no longer refuses a gradient: it runs
    ``MPOLinearFn`` over the stack (its plain versions on the CPU, one
    cores-backward call for the stack), and its gradients are the
    factorized mode's."""
    gen = torch.Generator().manual_seed(0)
    cfg = TL.MPOConfig(n=4, bond_ffn=8, mode="kernel")
    base = TL.init_linear(gen, 48, 96, cfg=cfg)["cores"]
    grads = {}
    for mode in ("kernel", "factorized"):
        lin = {"cores": {k: torch.stack([v, 0.5 * v]).requires_grad_() for k, v in base.items()}}
        x = torch.randn(2, 3, 48, generator=torch.Generator().manual_seed(1)).requires_grad_()
        calls = TMK.mpo_linear_bwd_cores_plain.calls
        y = TE.engine_for(dataclasses.replace(cfg, mode=mode)).linear(lin, x, phase="train")
        grads[mode] = torch.autograd.grad(y.square().sum(), [x, *lin["cores"].values()])
        assert TMK.mpo_linear_bwd_cores_plain.calls == calls + (mode == "kernel")
    for a, b in zip(grads["kernel"], grads["factorized"]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


# --------------------------------------------------------------------------
# the smoke models
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


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    tree = _weights(arch)
    js = JSession(jconfigs.smoke_config(arch), jax.tree.map(jnp.asarray, tree))
    ts = TSession.init(arch, device="cpu")
    load_jax_params(ts.model, tree)
    return js, ts


def _prompts(cfg, b=3, s=14, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_forward_and_aux_match_reference(pair):
    js, ts = pair
    flat = jax.tree_util.tree_flatten_with_path(js.params)[0]
    assert {k: tuple(v.shape) for k, v in ts.model.state_dict().items()} == \
        {".".join(p.key for p in path): leaf.shape for path, leaf in flat}
    tokens = _prompts(js.cfg, 2, 9)
    jl, jaux = js.model.forward(js.params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tl, taux = ts.model({"tokens": torch.from_numpy(tokens)}, with_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL, rtol=MODEL_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert float(taux) > 0


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_decode_and_greedy_tokens_match(pair, paged):
    """Prefill and three decode steps' logits over the same cache, then 8
    greedy tokens with the weight cache on and off."""
    js, ts = pair
    prompts = _prompts(js.cfg)
    jh = js.serve(3, 32, paged=paged, weight_cache=False)
    th = ts.serve(3, 32, paged=paged, weight_cache=False)
    jl = np.asarray(jh.prefill({"tokens": jnp.asarray(prompts)}))
    np.testing.assert_allclose(th.prefill({"tokens": prompts}).numpy(), jl,
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    tok = np.argmax(jl[:, -1], -1)[:, None].astype(np.int32)
    for _ in range(3):
        jt, jl = jh.decode(jnp.asarray(tok))
        tt, tl = th.decode(tok)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL, rtol=MODEL_TOL)
        assert np.array_equal(tt.numpy(), np.asarray(jt))
        tok = np.asarray(jt)
    for wc in (True, False):
        jo = js.serve(3, 32, paged=paged, weight_cache=wc).generate(
            {"tokens": jnp.asarray(prompts)}, 8)
        to = ts.serve(3, 32, paged=paged, weight_cache=wc).generate({"tokens": prompts}, 8)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo), f"weight_cache={wc}")


def test_cache_weights_over_layer_and_expert_stacks(pair):
    """The weight cache contracts every (layer, expert) matrix whose decode
    plan is ``cached`` into (L, E, I, J) W, the reference's values."""
    js, ts = pair
    jc = js.model.cache_weights(js.params)
    tc = ts.model.cache_weights(ts.params)
    experts = tc["layers"]["moe"]["experts"]
    cfg = ts.cfg
    assert experts["w_up"]["w"].shape == (cfg.num_layers, cfg.num_experts, cfg.d_model,
                                          cfg.d_ff)
    for name in ("w_up", "w_gate", "w_down"):
        np.testing.assert_allclose(experts[name]["w"].numpy(),
                                   np.asarray(jc["layers"]["moe"]["experts"][name]["w"]),
                                   atol=1e-6, rtol=1e-5)


def test_training_stages_raise_for_moe(pair):
    """Conversion and squeezing still raise for the moe family, naming the
    reference's limits (its Algorithm 1 and 2 fail on (L, E) expert stacks:
    ``tests/test_torch_moe_train.py`` shows both); fine-tuning runs
    (``tests/test_torch_moe_train.py`` holds it against the reference)."""
    _, ts = pair
    for call, where in ((lambda: ts.squeeze(max_iters=1), "repro/core/squeeze.py:69-77"),
                        (lambda: TSession.from_dense({}, ts.cfg, device="cpu"),
                         "repro/core/convert.py:56")):
        with pytest.raises(NotImplementedError, match=where):
            call()
