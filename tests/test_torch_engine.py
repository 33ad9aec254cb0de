"""The port's execution engine (``repro_torch.core.engine``) against the JAX
package's: plans, dispatch, the serving weight cache, and a whole smoke
model forced through the fused-kernel mode.

On the CPU the port must make the reference's interpret-mode decisions; for
a CUDA device (planning is pure Python, no card needed) its kernel-or-not
decisions must equal the reference's compiled (``interpret=False``) ones,
with every difference pinned by name.  These are the analytic plans: both
packages' measured autotuners are off here (``REPRO_TORCH_AUTOTUNE_MEASURE``
and ``REPRO_AUTOTUNE_MEASURE`` set to 0, on a card too), so the CUDA plans
are the no-measurement fallback; on the card the port's tuner decides the
``train`` and ``prefill`` plans by measurement, as the reference's does on
a TPU.  Tolerance for values: float32 paths summed in another order, 2e-4
on the logits of a 2-layer smoke model (~1e-6 relative observed)."""

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
from repro.kernels import mpo_linear as JMK
from repro.models import model as JModel
from repro_torch import configs as tconfigs
from repro_torch.core import engine as TE
from repro_torch.core import layers as TL
from repro_torch.core.carry import load_jax_params
from repro_torch.kernels import mpo_linear as TMK
from repro_torch.models import model as TModel

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

@pytest.fixture(autouse=True)
def _analytic_plans(monkeypatch):
    """No measured plan in either package: the analytic decisions compared."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_MEASURE", "0")
    monkeypatch.setenv("REPRO_AUTOTUNE_MEASURE", "0")
    TE.clear_plan_cache()
    yield
    TE.clear_plan_cache()


ARCHS = ("bert-base", "qwen3-14b")
MOE_VLM = ("phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b", "llava-next-34b")
HYBRID = "zamba2-7b"


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
    # a stack's matrices (the layers; the hybrid's Mamba2 blocks and its
    # shared attention blocks; the encdec's encoder and decoder, whose
    # self- and cross-attention matrices share their shapes), one layer's
    # shapes
    blocks = [params[k] for k in ("layers", "shared_attn", "encoder", "decoder") if k in params]
    blocks += [{"mamba": params["mamba"]}] if "mamba" in params else []
    for block in blocks:
        for grp in ("attn", "xattn", "mlp", "mamba"):
            for name, lin in block.get(grp, {}).items():
                if isinstance(lin, dict) and "cores" in lin:
                    out[name] = [c.shape[1:] for c in JL.cores_to_list(lin["cores"])]
    # a MoE layer's expert matrices, one expert's shapes (as the reference's
    # vmap over the experts shows them to its engine)
    for name, lin in params.get("layers", {}).get("moe", {}).get("experts", {}).items():
        out[f"experts/{name}"] = [c.shape[2:] for c in JL.cores_to_list(lin["cores"])]
    return out


def _jcfg(tcfg):
    return JL.MPOConfig(**dataclasses.asdict(tcfg))


@pytest.mark.parametrize("arch", ARCHS + MOE_VLM + (HYBRID, "whisper-tiny"))
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


# where the port's bf16 kernel takes a matrix the reference's kernel refuses:
# the reference's gate (``repro.kernels.mpo_linear.kernel_eligible``) wants
# the TPU's 128-lane alignment of J / j_1, which phi3.5-moe's expert w_up and
# w_gate (4096 -> 6400: 400 columns) and llama4-maverick's lm_head (5120 ->
# 202240: 40448) miss, and Hopper's kernel does not need (ROADMAP.md,
# Queue 3 H).  The reference rebuilds W there (``reconstruct``), the port
# fuses it (``kernel``): the same function within the kernels' tolerance.
QUEUE3_H = {("phi3.5-moe-42b-a6.6b", "experts/w_up"), ("phi3.5-moe-42b-a6.6b", "experts/w_gate"),
            ("llama4-maverick-400b-a17b", "lm_head")}


@pytest.mark.parametrize("arch", MOE_VLM)
def test_cuda_kernel_decisions_equal_reference_compiled_for_moe_and_vlm(arch):
    """bf16 plans for the card against the reference's compiled ones: each
    expert matrix at 32, 40 and 640 rows an expert (llama4-maverick's decode
    and prefill capacity at batch 8, phi3.5-moe's prefill), the others at a
    decode's 8 rows and a prefill's 8 x 512 (llava-next-34b: 8 x 1536,
    patches included).  Only the pinned Queue 3 H matrices differ, and only
    as ``reconstruct`` against ``kernel``."""
    tcfg = tconfigs.get_config(arch).mpo
    jcfg = _jcfg(tcfg)
    prefill = 8 * (1536 if arch == "llava-next-34b" else 512)
    kernels = 0
    for name, shapes in _matrix_shapes(jconfigs, arch, False).items():
        rows = (32, 40, 640) if name.startswith("experts/") else (8, prefill)
        for tokens in rows:
            for phase in ("prefill", "decode"):
                jm = _effective(JE.choose_mode, jcfg, shapes, tokens, phase,
                                interpret=False, dtype="bfloat16")
                tm = _effective(TE.choose_mode, tcfg, shapes, tokens, phase,
                                device="cuda", dtype="bfloat16")
                if (arch, name) in QUEUE3_H and jm != tm:
                    assert (jm, tm) == ("reconstruct", "kernel"), (name, tokens, phase)
                else:
                    assert tm == jm, (name, tokens, phase)
                kernels += tm == "kernel"
    assert kernels                      # the card's path reaches the kernel


def test_queue3_h_matrices_are_the_pinned_exception():
    """Each pinned matrix is where the packages' gates disagree: the
    reference's kernel is not eligible, the port's bf16 forward takes it
    (``csrc/mpo_linear_mma.cu``), so at a prefill of 640 rows an expert (the
    head: 4096) the reference plans ``reconstruct`` and the port
    ``kernel``."""
    for arch, name in sorted(QUEUE3_H):
        sh = _matrix_shapes(jconfigs, arch, False)[name]
        tcfg = tconfigs.get_config(arch).mpo
        tokens = 640 if name.startswith("experts/") else 4096
        assert not JMK.kernel_eligible(sh, JE.DEFAULT_BLOCK_M)
        assert TMK.forward_kernel(sh, "bfloat16") == "mma"
        assert JE.choose_mode(_jcfg(tcfg), sh, tokens, "prefill", interpret=False,
                              dtype="bfloat16")[0] == "reconstruct"
        assert TE.choose_mode(tcfg, sh, tokens, "prefill", device="cuda",
                              dtype="bfloat16")[0] == "kernel"


# the dense, moe and vlm configurations' bf16 plans for the card against the
# reference's compiled ones in all three phases (ROADMAP.md, Queue 3 H):
# every difference by matrix, phase and rows, each the reference rebuilding
# W (``reconstruct``) where the port fuses it (``kernel``).  The reasons:
# the reference's gate wants J / j_1 (and, with ``train=True``, I / i_1)
# to be a multiple of the TPU's 128 lanes and its backward to fit its VMEM
# budget; Hopper's kernels have neither floor.  The rows: a decode's 8, a
# fine-tuning batch's 2048 (16 x 128) and a prefill's 4096 (8 x 512); an
# expert matrix at 32, 40 and 640 rows an expert (llama4-maverick's decode
# and prefill capacity at batch 8, phi3.5-moe's prefill).  "embed" is the
# vocabulary matrix in its own orientation (J = d_model), "embed_T" the
# tied head E^T.  On the card these are the no-measurement fallback: with
# the tuner measuring (its default there) each of these matrices is decided
# by the race, as the reference's tuner decides them on a TPU.
_ROWS, _BIG, _EXP = (8, 2048, 4096), (2048, 4096), (32, 40, 640)
_ALL = ("train", "prefill", "decode")
DENSE_H = {
    "bert-base": {("embed", "train"): _BIG, ("embed_T", "train"): _BIG},
    "albert-base": {},
    "qwen3-14b": {**{(n, ph): _BIG for n in ("embed", "embed_T", "w_down") for ph in _ALL},
                  **{(n, ph): _ROWS for n in ("w_gate", "w_up") for ph in _ALL},
                  ("wq", "train"): _ROWS, ("wo", "train"): _ROWS},
    "gemma2-27b": {(n, ph): _BIG for n in ("embed", "embed_T") for ph in _ALL},
    "mistral-nemo-12b": {("w_down", "train"): _BIG, ("w_gate", "train"): _ROWS,
                         ("w_up", "train"): _ROWS},
    "nemotron-4-15b": {(n, ph): _BIG for n in ("embed", "embed_T", "lm_head") for ph in _ALL},
    "phi3.5-moe-42b-a6.6b": {("experts/w_down", "train"): _EXP,
                             **{(n, ph): _EXP for n in ("experts/w_gate", "experts/w_up")
                                for ph in _ALL}},
    "llama4-maverick-400b-a17b": {**{(n, "train"): _EXP for n in (
                                      "experts/w_down", "experts/w_gate", "experts/w_up")},
                                  **{("lm_head", ph): _BIG for ph in _ALL},
                                  ("wq", "train"): _ROWS, ("wo", "train"): _ROWS},
    "llava-next-34b": {("wq", "train"): _BIG, ("wo", "train"): _BIG},
}


@pytest.mark.parametrize("arch", sorted(DENSE_H))
def test_cuda_kernel_decisions_pin_every_difference_in_every_phase(arch):
    """Every factorized matrix, bf16, in ``train``, ``prefill`` and
    ``decode``: the port's analytic decision for the card equals the
    reference's compiled one except at ``DENSE_H``'s named cases, each
    ``reconstruct`` (reference) against ``kernel`` (port), where the port's
    gate admits the shapes and the reference's refuses them.  The pinned
    Queue 3 H matrices of the moe / vlm test are among them."""
    tcfg = tconfigs.get_config(arch).mpo
    jcfg = _jcfg(tcfg)
    shapes = _matrix_shapes(jconfigs, arch, False)
    seen = {}
    for name, sh in shapes.items():
        for tokens in _EXP if name.startswith("experts/") else _ROWS:
            for phase in _ALL:
                jm = _effective(JE.choose_mode, jcfg, sh, tokens, phase, interpret=False,
                                dtype="bfloat16")
                tm = _effective(TE.choose_mode, tcfg, sh, tokens, phase, device="cuda",
                                dtype="bfloat16")
                if jm != tm:
                    assert (jm, tm) == ("reconstruct", "kernel"), (name, tokens, phase)
                    seen.setdefault((name, phase), []).append(tokens)
    assert {k: tuple(v) for k, v in seen.items()} == DENSE_H[arch]
    for (name, phase), rows in DENSE_H[arch].items():
        train = phase == "train"
        assert TMK.kernel_eligible(shapes[name], dtype="bfloat16", train=train), name
        assert not JMK.kernel_eligible(shapes[name], JE.DEFAULT_BLOCK_M, train=train), name
    assert {(a, n) for a, n in QUEUE3_H if a == arch} <= {
        (arch, n) for n, ph in DENSE_H[arch] if ph == "prefill"}


# zamba2-7b's bf16 plans on the card against the reference's compiled ones,
# every difference by matrix, rows and phase, as (reference, port):
# - in_proj (3584 -> 14576 = 16 x 911): J is no multiple of the TPU's 128
#   lanes, so the reference's kernel refuses it at prefill (and in a
#   factorized decode, re-planned as a prefill); the port's bf16 forward
#   takes it (Queue 3 H, as phi3.5-moe's experts);
# - out_proj, w_up and w_down in training: the reference's backward does
#   not fit its VMEM budget at bond 128 (``kernel_fits(backward=True)``);
#   the port's cores backward keeps its scratch in device memory;
# - wo at a prefill of 1024 rows or more: the reference's kernel takes it,
#   the port's bf16 plan refuses it (split at bond 3, R and P take 3.28 MB
#   against ``_mma_split``'s cap of an eighth of the 25.7 MB bf16 W, 3.21 MB:
#   2% over; at bond 2 its shared memory would be 1.09 MB) and rebuilds W;
#   wq, wk and wv the reference refuses too, so both rebuild.
HYBRID_H = {("in_proj", "prefill"): ("reconstruct", "kernel", (8, 1024, 4096)),
            ("in_proj", "decode"): ("reconstruct", "kernel", (8, 1024, 4096)),
            ("out_proj", "train"): ("reconstruct", "kernel", (1024, 4096)),
            ("w_down", "train"): ("reconstruct", "kernel", (1024, 4096)),
            ("w_up", "train"): ("reconstruct", "kernel", (8, 1024, 4096)),
            ("wo", "prefill"): ("kernel", "reconstruct", (1024, 4096)),
            ("wo", "decode"): ("kernel", "reconstruct", (1024, 4096))}


def test_cuda_kernel_decisions_for_zamba2_7b_pin_every_difference():
    """Every factorized matrix of zamba2-7b (the Mamba2 blocks' in_proj and
    out_proj, the shared blocks' attention and MLP, the embedding and its
    transpose), bf16, at 8, 1024 and 4096 rows in every phase: the port's
    decision equals the reference's compiled one except at ``HYBRID_H``'s
    named cases, each in its direction."""
    tcfg = tconfigs.get_config(HYBRID).mpo
    jcfg = _jcfg(tcfg)
    shapes = _matrix_shapes(jconfigs, HYBRID, False)
    assert set(shapes) == {"embed", "embed_T", "in_proj", "out_proj", "wq", "wk", "wv", "wo",
                           "w_up", "w_down"}
    seen = {}
    for name, sh in shapes.items():
        for tokens in (8, 1024, 4096):
            for phase in ("train", "prefill", "decode"):
                jm = _effective(JE.choose_mode, jcfg, sh, tokens, phase, interpret=False,
                                dtype="bfloat16")
                tm = _effective(TE.choose_mode, tcfg, sh, tokens, phase, device="cuda",
                                dtype="bfloat16")
                if jm != tm:
                    seen.setdefault((name, phase), []).append((jm, tm, tokens))
    got = {k: (v[0][0], v[0][1], tuple(t for _, _, t in v)) for k, v in seen.items()}
    assert all(len({(a, b) for a, b, _ in v}) == 1 for v in seen.values()), seen
    assert got == HYBRID_H
    # the reasons: the alignment of in_proj's J, the port's routes
    assert TMK.forward_kernel(shapes["in_proj"], "bfloat16") == "mma"
    assert not JMK.kernel_eligible(shapes["in_proj"], JE.DEFAULT_BLOCK_M)
    for name in ("wq", "wk", "wv", "wo"):
        assert TMK.forward_kernel(shapes[name], "bfloat16") is None, name
        assert TMK.forward_kernel(shapes[name], "float32") == "cuda_core", name
    assert JMK.kernel_eligible(shapes["wo"], JE.DEFAULT_BLOCK_M)
    assert not any(JMK.kernel_eligible(shapes[n], JE.DEFAULT_BLOCK_M, train=True)
                   for n in ("out_proj", "w_up", "w_down"))


# whisper-tiny's plans on the card against the reference's compiled ones,
# every difference by matrix, phase and dtype, as (reference, port, rows):
# - bf16: the port's tensor-core plan (``_mma_split``) refuses every matrix
#   of its layers.  At the attention matrices (384 -> 384, cores (1,3,3,9)
#   (9,4,4,64) (64,4,4,64) (64,4,4,4) (4,2,2,1)) the split at bond 3 needs
#   425,984 B of R and P against the cap of an eighth of the bf16 W, 36,864
#   B, and at bond 2 302,080 B of shared memory against 232,448; at w_up
#   and w_down 1,310,720 B against 147,456.  So the port rebuilds W
#   (``reconstruct``) where the reference's kernel takes wq, wk, wv and wo
#   (the encoder's and the decoder's self- and cross-attention, which share
#   their shapes) in every phase from 8 rows and w_down from 128 rows in a
#   prefill; its w_up both packages rebuild (the reference's J / j_1 = 96
#   misses the TPU's 128 lanes).  The tied head is planned alike: ``kernel``
#   from 8 rows in both (the port's bf16 forward takes it);
# - float32: ``csrc/mpo_linear.cu`` takes every matrix of the layers, so the
#   port fuses w_up (whose J / j_1 the reference refuses) in every phase and
#   w_down in training (whose I / i_1 = 96 the reference's backward
#   refuses); the reference rebuilds W there.
WHISPER = "whisper-tiny"
WHISPER_ROWS = (8, 3584, 12000)
_ATTN = ("wq", "wk", "wv", "wo")
WHISPER_H = {
    "bfloat16": {**{(name, ph): ("kernel", "reconstruct", WHISPER_ROWS) for name in _ATTN
                    for ph in ("train", "prefill", "decode")},
                 ("w_down", "prefill"): ("kernel", "reconstruct", (3584, 12000)),
                 ("w_down", "decode"): ("kernel", "reconstruct", (3584, 12000))},
    "float32": {("w_up", "train"): ("reconstruct", "kernel", WHISPER_ROWS),
                ("w_up", "prefill"): ("reconstruct", "kernel", WHISPER_ROWS),
                ("w_up", "decode"): ("reconstruct", "kernel", WHISPER_ROWS),
                ("w_down", "train"): ("reconstruct", "kernel", (3584, 12000))},
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_kernel_decisions_for_whisper_tiny_pin_every_difference(dtype):
    """Every factorized matrix of whisper-tiny (its encoder's and decoder's
    attention, cross-attention and MLP, the embedding and its transpose),
    both dtypes, at 8 rows, a decoder prefill of 8 x 448 and the encoder's
    8 x 1500, in every phase: the port's decision equals the reference's
    compiled one except at ``WHISPER_H``'s named cases, each in its
    direction; and the reasons, from the routes and gates."""
    tcfg = tconfigs.get_config(WHISPER).mpo
    jcfg = _jcfg(tcfg)
    shapes = _matrix_shapes(jconfigs, WHISPER, False)
    assert set(shapes) == {"embed", "embed_T", "wq", "wk", "wv", "wo", "w_up", "w_down"}
    seen = {}
    for name, sh in shapes.items():
        for tokens in WHISPER_ROWS:
            for phase in ("train", "prefill", "decode"):
                jm = _effective(JE.choose_mode, jcfg, sh, tokens, phase, interpret=False,
                                dtype=dtype)
                tm = _effective(TE.choose_mode, tcfg, sh, tokens, phase, device="cuda",
                                dtype=dtype)
                if jm != tm:
                    seen.setdefault((name, phase), []).append((jm, tm, tokens))
    got = {k: (v[0][0], v[0][1], tuple(t for _, _, t in v)) for k, v in seen.items()}
    assert all(len({(a, b) for a, b, _ in v}) == 1 for v in seen.values()), seen
    assert got == WHISPER_H[dtype]
    layer = ("wq", "wk", "wv", "wo", "w_up", "w_down")
    if dtype == "bfloat16":
        # no bf16 route for the layers' matrices: no MPO kernel runs there
        assert all(TMK.forward_kernel(shapes[n], dtype) is None for n in layer)
        assert TMK.forward_kernel(shapes["embed_T"], dtype) == "mma"
        assert all(JMK.kernel_eligible(shapes[n], JE.DEFAULT_BLOCK_M) for n in _ATTN)
    else:
        assert all(TMK.forward_kernel(shapes[n], dtype) == "cuda_core" for n in layer)
        assert all(TMK.kernel_eligible(shapes[n], dtype=dtype, train=True) for n in layer)
    assert not JMK.kernel_eligible(shapes["w_up"], JE.DEFAULT_BLOCK_M)
    assert JMK.kernel_eligible(shapes["w_down"], JE.DEFAULT_BLOCK_M)
    assert not JMK.kernel_eligible(shapes["w_down"], JE.DEFAULT_BLOCK_M, train=True)
    # the encoder's, the decoder's and the cross-attention's matrices share
    # their shapes, so one entry a name covers all three
    params, _ = JL.split_annotations(jax.eval_shape(
        JModel.build(jconfigs.get_config(WHISPER)).init, jax.random.PRNGKey(0)))
    for block, grp in (("encoder", "attn"), ("decoder", "attn"), ("decoder", "xattn")):
        for name in _ATTN:
            cs = JL.cores_to_list(params[block][grp][name]["cores"])
            assert [c.shape[1:] for c in cs] == shapes[name], (block, grp, name)


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
