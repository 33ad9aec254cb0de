"""The port's execution engine (``repro_torch.core.engine``) against the JAX
package's: plans, dispatch, the serving weight cache, and a whole smoke
model forced through the fused-kernel mode.

On the CPU the port must make the reference's interpret-mode decisions; for
a CUDA device (planning is pure Python, no card needed) its kernel-or-not
decisions must equal the reference's compiled (``interpret=False``) ones.
Tolerance for values: float32 paths summed in another order, 2e-4 on the
logits of a 2-layer smoke model (~1e-6 relative observed)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import engine as JE
from repro.core import layers as JL
from repro.models import model as JModel
from repro_torch import configs as tconfigs
from repro_torch.core import engine as TE
from repro_torch.core import layers as TL
from repro_torch.core.carry import load_jax_params
from repro_torch.models import model as TModel

ARCHS = ("bert-base", "qwen3-14b")


def _matrix_shapes(cfg_mod, arch, smoke):
    """{name: core shapes} of every factorized matrix of the reference model,
    from its abstract params (nothing is drawn), plus the tied-logits W^T."""
    cfg = cfg_mod.smoke_config(arch) if smoke else cfg_mod.get_config(arch)
    params, _ = JL.split_annotations(
        jax.eval_shape(JModel.build(cfg).init, jax.random.PRNGKey(0)))
    out = {"embed": [c.shape for c in JL.cores_to_list(params["embed"]["cores"])]}
    out["embed_T"] = [(a, j, i, b) for a, i, j, b in out["embed"]]
    if "lm_head" in params:
        out["lm_head"] = [c.shape for c in JL.cores_to_list(params["lm_head"]["cores"])]
    for grp in ("attn", "mlp"):
        for name, lin in params["layers"][grp].items():
            if "cores" in lin:
                out[name] = [c.shape[1:] for c in JL.cores_to_list(lin["cores"])]
    return out


def _jcfg(tcfg):
    return JL.MPOConfig(**dataclasses.asdict(tcfg))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_cpu_plans_equal_reference_interpret(arch, smoke):
    tcfg = (tconfigs.smoke_config(arch) if smoke else tconfigs.get_config(arch)).mpo
    for name, shapes in _matrix_shapes(jconfigs, arch, smoke).items():
        assert TE.flops_factorized_per_token(shapes) == JE.flops_factorized_per_token(shapes)
        assert TE.flops_reconstruct(shapes) == JE.flops_reconstruct(shapes)
        assert TE.flops_dense_per_token(shapes) == JE.flops_dense_per_token(shapes)
        for tokens in (1, 8, 64, 1024, 4096):
            for phase in ("train", "prefill", "decode"):
                for dtype in ("float32", "bfloat16"):
                    jm, _ = JE.choose_mode(_jcfg(tcfg), shapes, tokens, phase,
                                           interpret=True, dtype=dtype)
                    tm, _ = TE.choose_mode(tcfg, shapes, tokens, phase, device="cpu",
                                           dtype=dtype)
                    assert tm == jm, (arch, name, tokens, phase, dtype)
                    assert tm != "kernel"


def _effective(choose, cfg, shapes, tokens, phase, **kw):
    """What ``linear`` runs over raw cores: a decode plan of ``cached`` is
    re-decided as a one-shot forward (both engines do this)."""
    mode, _ = choose(cfg, shapes, tokens, phase, **kw)
    if mode == "cached":
        mode, _ = choose(cfg, shapes, tokens, "prefill", **kw)
    return mode


def test_cuda_kernel_decisions_equal_reference_compiled_for_bert_base():
    tcfg = tconfigs.get_config("bert-base").mpo
    jcfg = _jcfg(tcfg)
    seen = {}
    for name, shapes in _matrix_shapes(jconfigs, "bert-base", False).items():
        for tokens in (8, 1024):
            for phase in ("prefill", "decode"):
                jm = _effective(JE.choose_mode, jcfg, shapes, tokens, phase,
                                interpret=False, dtype="bfloat16")
                tm = _effective(TE.choose_mode, tcfg, shapes, tokens, phase,
                                device="cuda", dtype="bfloat16")
                assert tm == jm, (name, tokens, phase)
                seen[(name, tokens, phase)] = tm
        seen[(name, 2048, "train")] = TE.choose_mode(tcfg, shapes, 2048, "train",
                                                     device="cuda", dtype="bfloat16")[0]
    # the decisions the serving path relies on (factorized weights, M = 8 x 128
    # at prefill and 8 at decode; the logits head sees the last position only)
    for name in ("wq", "wk", "wv", "wo", "w_up", "w_down"):
        assert seen[(name, 1024, "prefill")] == "kernel"
    for name in ("wq", "wk", "wv", "wo", "w_up"):
        assert seen[(name, 8, "decode")] == "kernel"
    assert seen[("w_down", 8, "decode")] == "factorized"
    # fine-tuning at 16 x 128 tokens: every attention and FFN matrix trains
    # through the kernels (forward, dL/dx over W^T, and the cores backward)
    for name in ("wq", "wk", "wv", "wo", "w_up", "w_down"):
        assert seen[(name, 2048, "train")] == "kernel", name
    assert seen[("embed_T", 8, "prefill")] == "factorized"
    assert seen[("embed_T", 8, "decode")] == "factorized"


def test_forced_mode_and_phase_validation():
    cfg = TL.MPOConfig(mode="factorized")
    shapes = [(1, 4, 4, 8), (8, 4, 4, 1)]
    assert TE.choose_mode(cfg, shapes, 4096, "prefill", device="cuda")[0] == "factorized"
    with pytest.raises(ValueError, match="unknown phase"):
        TE.choose_mode(TL.MPOConfig(), shapes, 8, "serve")
    eng = TE.engine_for(TL.MPOConfig())
    assert eng is TE.engine_for(TL.MPOConfig())
    assert eng.plan(shapes, 8, "prefill") is eng.plan(shapes, 8, "prefill")


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """Smoke weights under the reference's key paths (the execution mode does
    not change them), drawn by the port: the reference's own init compiles
    for seconds per config.  Their tree must be the reference's."""
    src = TModel.build(tconfigs.smoke_config(arch), seed=7, device="cpu")
    tree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), src.tree())
    abstract, _ = JL.split_annotations(jax.eval_shape(
        JModel.build(jconfigs.smoke_config(arch)).init, jax.random.PRNGKey(0)))
    assert jax.tree.structure(abstract) == jax.tree.structure(tree)
    assert [a.shape for a in jax.tree.leaves(abstract)] == \
        [a.shape for a in jax.tree.leaves(tree)]
    return tree


def _smoke_pair(arch, **mpo_kw):
    """Reference and port smoke models with the same (reference) weights."""
    tcfg = tconfigs.smoke_config(arch)
    tcfg = dataclasses.replace(tcfg, mpo=dataclasses.replace(tcfg.mpo, **mpo_kw))
    jcfg = jconfigs.smoke_config(arch)
    jm = JModel.build(dataclasses.replace(jcfg, mpo=_jcfg(tcfg.mpo)))
    jparams = _jax_params(arch)
    tm = load_jax_params(TModel.build(tcfg, device="cpu"),
                         jax.tree.map(np.asarray, jparams))
    return jm, jparams, tm


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_weights_matches_reference(arch):
    jm, jparams, tm = _smoke_pair(arch)
    jc = jm.cache_weights(jparams)
    tc = tm.cache_weights(tm.tree())

    def walk(j, t, path=""):
        assert isinstance(t, dict) == isinstance(j, dict), path
        if isinstance(j, dict):
            assert set(j) == set(t), path
            for k in j:
                walk(j[k], t[k], f"{path}.{k}")
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-5)

    walk(jc, tc)
    assert "w" in tc["layers"]["attn"]["wq"]           # densified: decode plan cached


@pytest.mark.parametrize("mode", ["factorized", "reconstruct", "kernel", "cached"])
@pytest.mark.parametrize("transpose", [False, True])
def test_linear_modes_agree(mode, transpose):
    cfg = TL.MPOConfig(n=4, bond_ffn=8, mode=mode)
    lin = TL.init_linear(torch.Generator().manual_seed(0), 48, 96, cfg=cfg)
    x = torch.randn(5, 96 if transpose else 48, generator=torch.Generator().manual_seed(1))
    y = TE.engine_for(cfg).linear(lin, x, transpose=transpose, phase="prefill")
    w = TL.cores_to_list(lin["cores"])
    from repro_torch.core import mpo as TM
    ref = x @ (TM.reconstruct(w).T if transpose else TM.reconstruct(w))
    torch.testing.assert_close(y, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_mode_model_matches_reference(arch):
    """Every MPO matmul of a smoke model forced to ``mode="kernel"``: the
    reference runs its Pallas kernel in interpret mode, the port its plain
    version (the CPU tensors' side of the same wrapper)."""
    jm, jparams, tm = _smoke_pair(arch, mode="kernel")
    tokens = np.random.default_rng(0).integers(0, jm.cfg.vocab_size, (2, 8)).astype(np.int32)
    jl, _ = jm.forward(jparams, {"tokens": jnp.asarray(tokens)})
    from repro_torch.kernels import mpo_linear as TMK
    calls = TMK.mpo_linear_plain.calls
    tl = tm({"tokens": torch.from_numpy(tokens)})
    assert TMK.mpo_linear_plain.calls > calls
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4, rtol=2e-4)
