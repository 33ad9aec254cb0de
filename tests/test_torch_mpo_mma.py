"""The tensor-core MPO-linear forward (``csrc/mpo_linear_mma.cu``), bfloat16
and float32: its launch plan on the CPU, and the kernel against its plain
version on the card.

``_mma_plan`` is pure Python, so the CPU tests hold what the engine's gate
admits at bert-base and mamba2-130m widths, the shared memory and scratch
each launch takes, the split of I at few rows, and which float32 shapes
keep the CUDA-core kernel (``forward_kernel``).  The ``cuda`` tests
(skipped without a card) hold the kernel against ``mpo_linear_plain``.
bf16 at ``2**-7`` of the largest output: both round one f32 sum to bf16
once, in another order, and the hi/lo pair carries W to ~2^-16 relative,
so one bf16 step (2^-8) of the largest output, doubled, bounds the gap.
float32 at 1e-4 of it (``chip_smoke.py``'s ``TOL``): the three-term split
carries x and W to ~2^-24 relative, and the f32 sums over up to 3072 terms
in another order differ by ~1e-6 relative.

The cores backward over an expert stack: how a stack's scratch is grouped
(``_bwd_group``) at the full-width expert shapes, and on the card the
stacked call against its plain version (``chip_smoke.py``'s ``TOL``) and,
bit for bit, against each matrix run alone."""

import ctypes
import math

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import mpo as TM
from repro_torch.core.layers import cores_to_list
from repro_torch.models import transformer as TT
from repro_torch.kernels import mpo_linear as TMK
from repro_torch.models import mamba as TMB
from repro_torch.models import model as TModel

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card "
                    "(run these on the H100 with `python -m pytest -q -m cuda "
                    "tests/test_torch_mpo_mma.py`)")
    return torch.device("cuda")


def _matrices() -> dict:
    """Core shapes of the six matrices the bf16 kernel serves at bert-base
    and mamba2-130m widths, abstractly (no weights drawn); the heads in the
    orientation the logits use (E^T)."""
    with torch.device("meta"):
        bert = TModel.transformer.init(torch.Generator(), configs.get_config("bert-base"))
        mamba = TMB.init(torch.Generator(), configs.get_config("mamba2-130m"))
    layer = lambda p, grp, name: [tuple(c.shape[1:]) for c in cores_to_list(
        (p["layers"][grp] if grp else p["layers"])[name]["cores"])]
    head = [tuple(c.shape) for c in cores_to_list(mamba["embed"]["cores"])]
    return {"attn": layer(bert, "attn", "wq"), "w_up": layer(bert, "mlp", "w_up"),
            "w_down": layer(bert, "mlp", "w_down"),
            "in_proj": layer(mamba, None, "in_proj"),
            "out_proj": layer(mamba, None, "out_proj"),
            "head": [(d0, j, i, d1) for d0, i, j, d1 in head]}


def _swap(shapes):
    return [(d0, j, i, d1) for d0, i, j, d1 in shapes]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["attn", "w_up", "w_down", "in_proj", "out_proj", "head"])
def test_mma_plan_admits_the_models_matrices(name, dtype):
    shapes = _matrices()[name]
    assert _matrices()["head"][0] == (1, 3, 197, 48)
    for sh in (shapes, _swap(shapes)):
        assert TMK.kernel_eligible(sh, dtype=dtype), (name, sh)
        assert TMK.kernel_eligible(sh, dtype=dtype, train=True), (name, sh)
        assert TMK.forward_kernel(sh, dtype) == "mma", (name, sh)
        # the same bond in both dtypes
        assert TMK._mma_split(tuple(sh), dtype) == TMK._mma_split(tuple(sh)), (name, sh)
        i_dim = math.prod(c[1] for c in sh)
        j_dim = math.prod(c[2] for c in sh)
        for m in (1, 8, 64, 100, 2048, 4096):
            plan = TMK._mma_plan(tuple(sh), m, dtype)
            assert plan is not None and plan.smem <= TMK.SMEM_LIMIT, (name, m, plan)
            # these matrices' float32 stages fit the 128-row tile too
            assert plan.bm == (16 if m <= 16 else 64 if m <= 64 else 128)
            assert plan.tc in (2, 4)
            # scratch is R, P and the split partials: under a quarter of a bf16 W
            assert 4 * plan.workspace < 2 * i_dim * j_dim, (name, m, plan)
            if m > TMK.SPLIT_M:
                assert plan.splits == 1


def test_mma_plan_splits_i_at_few_rows_only_where_the_card_is_idle():
    mats = _matrices()
    attn = TMK._mma_plan(tuple(mats["attn"]), 8)
    assert attn.splits > 1                          # 6 tiles on 132 SMs
    tiles = -(-768 // TMK.MMA_BN)
    assert tiles * attn.splits <= 2 * TMK.MMA_SMS + tiles
    # 394 tiles already fill two waves: the head keeps S = 1
    assert TMK._mma_plan(tuple(mats["head"]), 8).splits == 1
    assert TMK._mma_plan(tuple(mats["attn"]), 2048).splits == 1
    # every split owns at least one stage of I
    for name, sh in mats.items():
        for m in (1, 8, 64):
            plan = TMK._mma_plan(tuple(sh), m)
            nst = -(-math.prod(c[1] for c in sh) // TMK.MMA_BK)
            per = -(-nst // plan.splits)
            assert (plan.splits - 1) * per < nst, (name, m, plan)


def _config_matrices(arch, smoke):
    """{name: core shapes} of every factorized matrix of a config as the port
    initializes it (abstractly), stacked layer dims dropped, and the tied
    logits' E^T."""
    cfg = configs.smoke_config(arch) if smoke else configs.get_config(arch)
    init = TMB.init if cfg.family == "ssm" else TT.init
    with torch.device("meta"):
        params = init(torch.Generator(), cfg)
    out = {}

    def walk(tree, path):
        if "cores" in tree:
            out[path] = [tuple(c.shape[-4:]) for c in cores_to_list(tree["cores"])]
            return
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{path}/{k}" if path else k)

    walk(params, "")
    out["embed^T"] = _swap(out["embed"])
    return out


# the float32 shapes the tensor-core plan refuses (W of 64 x 64 to 128 x 64:
# no bond keeps R and P within an eighth of it; qwen3-14b's lm_head: no
# bond's js group divides the 128-column tile), which keep csrc/mpo_linear.cu
NARROW = {
    ("bert-base", True): {f"layers/{g}" for g in (
        "attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w_up", "mlp/w_down")},
    ("qwen3-14b", True): {f"layers/{g}" for g in (
        "attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w_up", "mlp/w_down", "mlp/w_gate")},
    ("mamba2-130m", True): {"layers/out_proj"},
    ("bert-base", False): set(),
    ("qwen3-14b", False): {"lm_head"},
    ("mamba2-130m", False): set(),
}


@pytest.mark.parametrize("arch", ["bert-base", "qwen3-14b", "mamba2-130m"])
@pytest.mark.parametrize("smoke", [True, False])
def test_f32_eligibility_is_unchanged_and_narrow_shapes_keep_the_cuda_core_kernel(arch, smoke):
    """``kernel_eligible(dtype="float32")`` admits what ``csrc/mpo_linear.cu``
    takes (every matrix of every config, both orientations), so the
    engine's float32 plans do not depend on the tensor-core plan; and
    ``forward_kernel`` sends float32 to the CUDA-core kernel exactly for the
    narrow shapes, from the shapes alone, where bf16 is refused too."""
    mats = _config_matrices(arch, smoke)
    assert NARROW[(arch, smoke)] <= set(mats)
    for name, shapes in mats.items():
        for sh in (shapes, _swap(shapes)):
            assert TMK.kernel_eligible(sh, dtype="float32"), (arch, name, sh)
            assert TMK._narrow_plan(tuple(sh), 8) is not None
            narrow = name in NARROW[(arch, smoke)]
            assert TMK.forward_kernel(sh, "float32") == ("cuda_core" if narrow else "mma"), (
                arch, smoke, name, sh)
            assert TMK.forward_kernel(sh, "bfloat16") == (None if narrow else "mma")
    assert TMK.forward_kernel(mats["embed"], "float16") is None


def test_f32_plan_tile_falls_to_64_rows_where_128_does_not_fit():
    """bert-base's vocabulary matrix (30720 x 768): R is 160 KB, so float32
    takes it at 64-row tiles above 64 rows, and bf16 at 128."""
    emb = tuple(_config_matrices("bert-base", False)["embed^T"])
    assert emb[0] == (1, 3, 10, 30)
    f32, bf16 = TMK._mma_plan(emb, 1024, "float32"), TMK._mma_plan(emb, 1024)
    assert (f32.bm, bf16.bm) == (64, 128)
    assert f32.smem <= TMK.SMEM_LIMIT < TMK._mma_smem_bytes(
        TMK._mma_geometry(emb, f32.split, "float32"), 128, "float32")
    # float32 needs I in whole 4-float chunks, bf16 in whole 8-element ones
    four = ((1, 3, 64, 2), (2, 4, 32, 1))             # I = 12
    assert TMK._mma_split(four, "float32") == 1 and TMK._mma_split(four) is None


@pytest.mark.parametrize("shapes", [
    [(1, 64, 64, 1)],                               # one core
    [(1, 4, 4, 8)] * 9,                             # more than 8 cores
    [(1, 4, 4, 8), (4, 4, 4, 1)],                   # broken chain
    [(1, 3, 4, 4), (4, 3, 4, 1)],                   # I = 9: not whole 16-byte chunks
    [(1, 64, 2, 8), (8, 2, 256, 1)],                # no bond gives whole js groups a tile
    [(1, 64, 64, 2048), (2048, 64, 64, 1)],         # R never fits shared memory
])
def test_mma_plan_refuses_what_the_kernel_cannot_take(shapes):
    assert TMK._mma_split(tuple(shapes)) is None
    assert TMK._mma_plan(tuple(shapes), 8) is None
    assert not TMK.kernel_eligible(shapes, dtype="bfloat16")
    if shapes[0] != (1, 3, 4, 4):                   # I = 9 is not whole 4-float chunks either
        assert TMK._mma_split(tuple(shapes), "float32") is None


def test_bf16_wrapper_raises_for_other_devices_and_mixed_dtypes():
    cores = [torch.zeros(s, dtype=torch.bfloat16) for s in [(1, 4, 4, 4), (4, 8, 8, 1)]]
    meta = [c.to("meta") for c in cores]
    x = torch.zeros(2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        TMK.mpo_linear(meta, x.to("meta"))
    with pytest.raises(ValueError, match="x's dtype"):
        TMK.mpo_linear([c.float() for c in meta], x.to("meta"))
    # the CPU takes the plain version, never the kernel
    calls, launches = TMK.mpo_linear_plain.calls, TMK.mpo_linear_mma.launches
    y = TMK.mpo_linear(cores, x)
    assert TMK.mpo_linear_plain.calls == calls + 1 and TMK.mpo_linear_mma.launches == launches
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (2, 32)


def test_hi_lo_pair_carries_w_where_one_bf16_w_would_not():
    """The kernel's arithmetic on the CPU: W in f32 enters as bf16(W) +
    bf16(W - bf16(W)), each product exact in f32.  That sum stays within
    2^-14 of the f32 product's largest magnitude, one bf16 W drifts ~2^-8:
    the extra rounding ``LAYER_TOL`` exists to catch."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 768)).astype(np.float32)).bfloat16().float()
    w = torch.from_numpy(rng.standard_normal((768, 256)).astype(np.float32) / 28)
    hi = w.bfloat16().float()
    lo = (w - hi).bfloat16().float()
    exact = x.double() @ w.double()
    scale = exact.abs().max().item()
    pair = ((x @ hi) + (x @ lo)).double()
    single = (x @ hi).double()
    assert (pair - exact).abs().max().item() <= 2.0 ** -14 * scale
    assert (single - exact).abs().max().item() > 2.0 ** -10 * scale


def _terms(t: torch.Tensor, n: int) -> list[torch.Tensor]:
    """``t`` as n bf16 terms, each bf16 of what the terms before it leave:
    the split ``csrc/mpo_linear_mma.cu`` makes of f32 x and W."""
    out, rest = [], t.clone()
    for _ in range(n):
        out.append(rest.bfloat16().float())
        rest = rest - out[-1]
    return out


def test_three_term_split_carries_f32_where_the_pair_would_not():
    """The float32 kernel's arithmetic on the CPU: x and W in f32 enter as
    three bf16 terms each and the six products of size >= 2^-24 of x0.w0
    are summed, each exact in f32.  With the sums taken in float64 (the
    split alone), that stays within 2^-24 of the exact product's largest
    magnitude, below float32's own product (summed in f32: ~2^-21 here);
    the bf16 kernel's arithmetic (x in one bf16 term, W as the pair) misses
    by more than 2^-10, and a pair for each of x and W (x0.w0, x0.w1,
    x1.w0) by more than 2^-20: more than float32's product."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 768)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((768, 256)).astype(np.float32) / 28)
    exact = x.double() @ w.double()
    scale = exact.abs().max().item()
    x3, w3 = _terms(x, 3), _terms(w, 3)
    six = sum((x3[i].double() @ w3[j].double()) for i, j in
              ((2, 0), (1, 1), (1, 0), (0, 2), (0, 1), (0, 0)))
    err = lambda y: (y - exact).abs().max().item()
    assert err(six) <= 2.0 ** -24 * scale
    assert err((x @ w).double()) <= 2.0 ** -20 * scale
    bf16_path = sum(x3[0].double() @ wt.double() for wt in w3[:2])
    assert err(bf16_path) > 2.0 ** -10 * scale
    pairs = sum(x3[i].double() @ w3[j].double() for i, j in ((1, 0), (0, 1), (0, 0)))
    assert err(pairs) > 2.0 ** -20 * scale


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["attn", "w_up", "w_down", "in_proj", "attn^T"])
def test_cuda_mma_matches_plain(cuda, name, dtype):
    mats = _matrices()
    shapes = _swap(mats["attn"]) if name == "attn^T" else mats[name]
    rng = np.random.default_rng(0)
    # each core's entries scaled so W's entries are O(1 / sqrt(I))
    i_dim = math.prod(c[1] for c in shapes)
    sigma = (1.0 / i_dim / math.prod(c[3] for c in shapes[:-1])) ** (1 / (2 * len(shapes)))
    tdt = getattr(torch, dtype)
    tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-4
    cores = [torch.from_numpy((rng.standard_normal(s) * sigma).astype(np.float32))
             .to(cuda, tdt) for s in shapes]
    j_dim = math.prod(c[2] for c in shapes)
    for m in (1, 8, 48, 100, 2048):                 # 16-, 64- and 128-row tiles
        x = torch.from_numpy(rng.standard_normal((m, i_dim)).astype(np.float32)).to(cuda, tdt)
        launches, other = TMK.mpo_linear_mma.launches, TMK.mpo_linear_cuda_core.launches
        y = TMK.mpo_linear(cores, x)
        again = TMK.mpo_linear(cores, x)
        torch.cuda.synchronize()
        assert TMK.mpo_linear_mma.launches == launches + 2
        assert TMK.mpo_linear_cuda_core.launches == other      # not the CUDA-core kernel
        assert torch.equal(y, again), (name, m)                # same bits
        assert 4 * TMK.mpo_linear_mma.workspace_bytes < 2 * i_dim * j_dim
        ref = TMK.mpo_linear_plain(cores, x).float()
        err = (y.float() - ref).abs().max().item()
        assert err <= tol * ref.abs().max().item(), (name, m, err)
        assert y.dtype == tdt and tuple(y.shape) == (m, j_dim)


@pytest.mark.cuda
def test_cuda_f32_falls_back_to_64_row_tiles(cuda):
    """bert-base's vocabulary matrix (E^T, 768 -> 30720) in float32 at 100
    rows: the plan takes 64-row tiles, where 128 would not fit shared
    memory; within 1e-4 of the plain version, two launches bit-identical."""
    emb = [tuple(c) for c in _config_matrices("bert-base", False)["embed^T"]]
    assert TMK._mma_plan(tuple(emb), 100, "float32").bm == 64
    rng = np.random.default_rng(1)
    i_dim = math.prod(c[1] for c in emb)
    sigma = (1.0 / i_dim / math.prod(c[3] for c in emb[:-1])) ** (1 / (2 * len(emb)))
    cores = [torch.from_numpy((rng.standard_normal(s) * sigma).astype(np.float32)).to(cuda)
             for s in emb]
    x = torch.from_numpy(rng.standard_normal((100, i_dim)).astype(np.float32)).to(cuda)
    y, again = TMK.mpo_linear(cores, x), TMK.mpo_linear(cores, x)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    ref = TMK.mpo_linear_plain(cores, x)
    assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["attn", "w_down", "smoke wq"])
def test_cuda_stacked_forward_matches_plain(cuda, name, dtype):
    """A stack of 5 matrices (a MoE layer's experts) in one launch: within
    the tolerance of the plain version over the stack, each matrix's rows
    bit-identical to that matrix run alone (the same plan, the same
    arithmetic), two launches bit-identical; one launch a call, counted as a
    stacked launch (a matrix run alone is not).  bert-base's
    attn and w_down take the tensor-core kernel (both dtypes; the split of I
    at few rows, 16-, 64- and 128-row tiles), smoke bert-base's wq in
    float32 the CUDA-core one.  The plan's workspace for the stack is the
    CUDA source's."""
    if name == "smoke wq":
        if dtype == "bfloat16":
            pytest.skip("no bf16 kernel takes smoke bert-base's wq (forward_kernel is None)")
        with torch.device("meta"):
            smoke = TModel.transformer.init(torch.Generator(), configs.smoke_config("bert-base"))
        shapes = [tuple(c.shape[1:]) for c in cores_to_list(smoke["layers"]["attn"]["wq"]["cores"])]
    else:
        shapes = _matrices()[name]
    route = TMK.forward_kernel(shapes, dtype)
    counter = TMK.mpo_linear_mma if route == "mma" else TMK.mpo_linear_cuda_core
    e, tdt = 5, getattr(torch, dtype)
    tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-4
    rng = np.random.default_rng(3)
    i_dim = math.prod(c[1] for c in shapes)
    j_dim = math.prod(c[2] for c in shapes)
    sigma = (1.0 / i_dim / math.prod(c[3] for c in shapes[:-1])) ** (1 / (2 * len(shapes)))
    cores = [torch.from_numpy((rng.standard_normal((e,) + s) * sigma).astype(np.float32))
             .to(cuda, tdt) for s in shapes]
    for m in (1, 40, 100, 300):
        x = torch.from_numpy(rng.standard_normal((e, m, i_dim)).astype(np.float32)).to(cuda, tdt)
        launches, stacked = counter.launches, counter.stacked_launches
        y = TMK.mpo_linear(cores, x)
        again = TMK.mpo_linear(cores, x)
        torch.cuda.synchronize()
        assert counter.launches == launches + 2 and y.shape == (e, m, j_dim)
        assert counter.stacked_launches == stacked + 2
        assert torch.equal(y, again), (name, m)
        for k in (0, e - 1):
            alone = TMK.mpo_linear([c[k].contiguous() for c in cores], x[k].contiguous())
            assert torch.equal(y[k], alone), (name, m, k)
        assert counter.stacked_launches == stacked + 2
        ref = TMK.mpo_linear_plain(cores, x).float()
        err = (y.float() - ref).abs().max().item()
        assert err <= tol * ref.abs().max().item(), (name, m, err)
        if route == "mma":
            plan = TMK._mma_plan(tuple(shapes), m, dtype)
            dims = (ctypes.c_int * (4 * len(shapes)))(*[d for s in shapes for d in s])
            ws = TMK._mma_lib().mpo_linear_mma_workspace(dims, len(shapes), plan.split, m,
                                                         plan.splits, e, TMK.DTYPES[tdt])
            assert 4 * ws == e * plan.workspace


# --------------------------------------------------------------------------
# the float32 forward for the narrow shapes (csrc/mpo_linear.cu)
# --------------------------------------------------------------------------


def _port_shapes(arch, *path, smoke=False):
    """One matrix's core shapes (stack dims dropped) in the port's config,
    abstractly (no weights drawn)."""
    cfg = configs.smoke_config(arch) if smoke else configs.get_config(arch)
    with torch.device("meta"):
        node = TModel.family_module(cfg).init(torch.Generator(), cfg)
    for k in path:
        node = node[k]
    return tuple(tuple(c.shape[-4:]) for c in cores_to_list(node["cores"]))


# the full-width matrices the card test holds csrc/mpo_linear.cu to, with the
# rows it runs them at: every count of the issue's list for whisper-tiny's
# (12000 = its encoder at 8 x 1500); 4352 (gemma2-27b's long prefill) in
# place of 12000 where each of 47 row tiles would rebuild a W of 170 M
# (gemma2-27b) to 778 M (qwen3-14b) values
NARROW_CARD = {
    "whisper-tiny attn": (("whisper-tiny", "encoder", "attn", "wq"), (2, 8, 64, 1024, 12000)),
    "whisper-tiny w_up": (("whisper-tiny", "encoder", "mlp", "w_up"), (2, 8, 64, 1024, 12000)),
    "whisper-tiny w_down": (("whisper-tiny", "encoder", "mlp", "w_down"),
                            (2, 8, 64, 1024, 12000)),
    "zamba2-7b wq": (("zamba2-7b", "shared_attn", "attn", "wq"), (2, 8, 64, 128, 1024)),
    "gemma2-27b w_down": (("gemma2-27b", "layers", "mlp", "w_down"), (2, 8, 64, 1024, 4352)),
    "qwen3-14b lm_head": (("qwen3-14b", "lm_head"), (2, 8, 64, 1024)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NARROW_CARD))
def test_cuda_narrow_forward_matches_plain(cuda, name):
    """``csrc/mpo_linear.cu`` at the full-width matrices that take it: one
    launch a call and none of the tensor-core kernel or the plain version,
    within ``chip_smoke.py``'s float32 tolerance of ``mpo_linear_plain``
    (1e-4 of the largest output, grown as the root of I past 3072 terms:
    the rounding of the f32 sums in another order), two launches
    bit-identical, the plan's shared memory and workspace the CUDA
    source's, the workspace below a quarter of the bf16 W."""
    path, rows = NARROW_CARD[name]
    shapes = _port_shapes(*path)
    assert TMK.forward_kernel(shapes, "float32") == "cuda_core"
    rng = np.random.default_rng(5)
    i_dim = math.prod(c[1] for c in shapes)
    j_dim = math.prod(c[2] for c in shapes)
    sigma = (1.0 / i_dim / math.prod(c[3] for c in shapes[:-1])) ** (1 / (2 * len(shapes)))
    cores = [torch.from_numpy((rng.standard_normal(s) * sigma).astype(np.float32)).to(cuda)
             for s in shapes]
    tol = 1e-4 * math.sqrt(max(i_dim, 3072) / 3072)
    dims = (ctypes.c_int * (4 * len(shapes)))(*[d for s in shapes for d in s])
    lib = TMK._lib()
    for m in rows:
        x = torch.randn(m, i_dim, generator=torch.Generator().manual_seed(m)).to(cuda)
        before = (TMK.mpo_linear_cuda_core.launches, TMK.mpo_linear_mma.launches,
                  TMK.mpo_linear_plain.calls)
        y = TMK.mpo_linear(cores, x)
        again = TMK.mpo_linear(cores, x)
        torch.cuda.synchronize()
        assert (TMK.mpo_linear_cuda_core.launches, TMK.mpo_linear_mma.launches,
                TMK.mpo_linear_plain.calls) == (before[0] + 2, before[1], before[2])
        assert torch.equal(y, again), (name, m)
        plan = TMK._narrow_plan(shapes, m)
        assert TMK.mpo_linear_cuda_core.workspace_bytes == plan.workspace
        assert 4 * plan.workspace < 2 * i_dim * j_dim
        assert lib.mpo_linear_fwd_smem(dims, len(shapes), plan.split, plan.bm, plan.ch,
                                       plan.lq) == plan.smem
        assert lib.mpo_linear_fwd_workspace(dims, len(shapes), plan.split, m, plan.splits,
                                            1) == plan.workspace
        ref = TMK.mpo_linear_plain(cores, x)
        err = (y - ref).abs().max().item()
        assert err <= tol * ref.abs().max().item(), (name, m, err)
        assert y.dtype == torch.float32 and tuple(y.shape) == (m, j_dim)
        del x, y, again, ref
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_cuda_narrow_forward_over_a_smoke_expert_stack(cuda):
    """smoke phi3.5-moe's 4 experts' w_up (and its dL/dx, w_up^T) in one
    launch: within 1e-4 of the plain version, each expert's rows bit-equal
    to its matrix run alone, two launches bit-identical, counted as stacked
    launches; the stack's workspace E times a matrix's."""
    shapes = _port_shapes("phi3.5-moe-42b-a6.6b", "layers", "moe", "experts", "w_up",
                          smoke=True)
    e = configs.smoke_config("phi3.5-moe-42b-a6.6b").num_experts
    assert e == 4
    rng = np.random.default_rng(6)
    for sh in (shapes, tuple(_swap(shapes))):
        assert TMK.forward_kernel(sh, "float32") == "cuda_core"
        i_dim = math.prod(c[1] for c in sh)
        j_dim = math.prod(c[2] for c in sh)
        cores = [torch.from_numpy((rng.standard_normal((e,) + c) * 0.4).astype(np.float32))
                 .to(cuda) for c in sh]
        dims = (ctypes.c_int * (4 * len(sh)))(*[d for c in sh for d in c])
        for m in (1, 7, 28, 300):
            x = torch.from_numpy(rng.standard_normal((e, m, i_dim)).astype(np.float32)).to(cuda)
            launches, stacked = (TMK.mpo_linear_cuda_core.launches,
                                 TMK.mpo_linear_cuda_core.stacked_launches)
            y, again = TMK.mpo_linear(cores, x), TMK.mpo_linear(cores, x)
            torch.cuda.synchronize()
            assert TMK.mpo_linear_cuda_core.launches == launches + 2
            assert TMK.mpo_linear_cuda_core.stacked_launches == stacked + 2
            assert torch.equal(y, again) and tuple(y.shape) == (e, m, j_dim)
            for k in range(e):
                alone = TMK.mpo_linear([c[k].contiguous() for c in cores], x[k].contiguous())
                assert torch.equal(y[k], alone), (m, k)
            plan = TMK._narrow_plan(sh, m)
            assert TMK._lib().mpo_linear_fwd_workspace(dims, len(sh), plan.split, m,
                                                       plan.splits, e) == e * plan.workspace
            ref = TMK.mpo_linear_plain(cores, x)
            assert (y - ref).abs().max() <= 1e-4 * ref.abs().max(), m


@pytest.mark.cuda
def test_cuda_forward_raises_where_no_kernel_takes_the_shapes(cuda):
    """No fallback: float32 cores whose every bond's R passes a block's
    shared memory raise on the card, and neither kernel nor the plain
    version runs."""
    cores = [torch.zeros(1, 64, 64, 2048, device=cuda), torch.zeros(2048, 64, 64, 1, device=cuda)]
    x = torch.zeros(4, 4096, device=cuda)
    before = (TMK.mpo_linear_cuda_core.launches, TMK.mpo_linear_mma.launches,
              TMK.mpo_linear_plain.calls)
    with pytest.raises(ValueError, match="no float32 kernel"):
        TMK.mpo_linear(cores, x)
    assert (TMK.mpo_linear_cuda_core.launches, TMK.mpo_linear_mma.launches,
            TMK.mpo_linear_plain.calls) == before


# --------------------------------------------------------------------------
# the cores backward over an expert stack
# --------------------------------------------------------------------------


def test_bwd_group_fits_the_budget():
    """A stack runs in groups of experts whose scratch fits
    ``BWD_STACK_SCRATCH``: all of them when they fit, else the fewest
    groups of equal size.  At the full-width expert shapes one matrix's
    scratch is above an f32 dW (L and dL are W-sized at the only bond whose R
    fits), so phi3.5-moe's 16 experts run as 2 groups of 8 and
    llama4-maverick's 128 as 16 groups of 8."""
    budget = TMK.BWD_STACK_SCRATCH
    assert TMK._bwd_group(1000, 5) == 5
    assert TMK._bwd_group(budget + 1, 4) == 1
    for ws, n, want in ((budget // 3 + 1, 7, 2), (budget // 5, 16, 4), (budget // 8, 16, 8)):
        g = TMK._bwd_group(ws, n)
        groups = -(-n // g)
        # fits, the fewest groups that fit, and no group larger than the first
        assert g * ws <= budget and -(-n // (groups - 1)) * ws > budget and g == want, (ws, n)
    from repro_torch.models import nn as TNN
    for arch, groups in (("phi3.5-moe-42b-a6.6b", 2), ("llama4-maverick-400b-a17b", 16)):
        cfg = configs.get_config(arch)
        with torch.device("meta"):           # one expert's matrices
            expert = TNN.init_mlp(torch.Generator(), cfg.d_model, cfg.d_ff, cfg.mlp_act,
                                  cfg.mpo)
        for name in ("w_up", "w_down"):
            shapes = tuple(tuple(c.shape) for c in cores_to_list(expert[name]["cores"]))
            plan = TMK._bwd_plan(shapes, "bfloat16")
            assert plan is not None and TMK.kernel_eligible(shapes, dtype="bfloat16", train=True)
            i_dim = math.prod(s[1] for s in shapes)
            j_dim = math.prod(s[2] for s in shapes)
            assert plan.workspace > 4 * i_dim * j_dim
            g = TMK._bwd_group(plan.workspace, cfg.num_experts)
            assert (g, -(-cfg.num_experts // g)) == (8, groups), (arch, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_stacked_bwd_cores_matches_plain(cuda, dtype, monkeypatch):
    """The cores backward over a stack of 3 matrices (bert-base's attention
    and w_down shapes, and ``tests/test_kernel_vjp.py``'s (24, 36): element
    loads, a cluster of one) on the card: within ``chip_smoke.py``'s ``TOL``
    of the plain version, two calls bit-identical, each expert bit-equal to
    its matrix run alone, an all-zero expert exactly zero, the central core
    skipped leaving the others' bits; one call counted once and as stacked;
    the stack's scratch the CUDA source's.  Then the experts in groups (a
    budget of two experts' scratch: a group of 2, then 1) give the same
    bits."""
    mats = _matrices()
    cases = [mats["attn"], mats["w_down"],
             [tuple(c) for c in TM.MPOSpec.make(24, 36, n=3).core_shapes()]]
    tdt, e = getattr(torch, dtype), 3
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7
    rng = np.random.default_rng(0)
    for shapes in cases:
        i_dim = math.prod(c[1] for c in shapes)
        j_dim = math.prod(c[2] for c in shapes)
        cs = [torch.from_numpy((rng.standard_normal((e,) + c) * 0.35).astype(np.float32))
              .to(cuda, tdt) for c in shapes]
        plan = TMK._bwd_plan(tuple(shapes), dtype, TMK._sm_count(cuda.index or 0))
        for m in (37, 160):
            x = torch.from_numpy(rng.standard_normal((e, m, i_dim)).astype(np.float32))
            dy = torch.from_numpy(rng.standard_normal((e, m, j_dim)).astype(np.float32))
            x[1], dy[1] = 0.0, 0.0
            x, dy = x.to(cuda, tdt), dy.to(cuda, tdt)
            launches, stacked = TMK.mpo_linear_bwd_cores.launches, \
                TMK.mpo_linear_bwd_cores.stacked_launches
            got = TMK.mpo_linear_bwd_cores(cs, x, dy)
            again = TMK.mpo_linear_bwd_cores(cs, x, dy)
            torch.cuda.synchronize()
            assert TMK.mpo_linear_bwd_cores.launches == launches + 2
            assert TMK.mpo_linear_bwd_cores.stacked_launches == stacked + 2
            assert TMK.mpo_linear_bwd_cores.launch_sets == 1
            assert TMK.mpo_linear_bwd_cores.workspace_bytes == e * plan.workspace
            assert all(torch.equal(a, b) for a, b in zip(got, again)), (shapes, m)
            for k in range(e):
                alone = TMK.mpo_linear_bwd_cores([c[k].contiguous() for c in cs],
                                                 x[k].contiguous(), dy[k].contiguous())
                assert all(torch.equal(g[k], a) for g, a in zip(got, alone)), (shapes, m, k)
            assert all(not g[1].any() for g in got)
            for g, r in zip(got, TMK.mpo_linear_bwd_cores_plain(cs, x, dy)):
                r = r.float()
                assert (g.float() - r).abs().max() <= tol * r.abs().max(), (shapes, m)
            central = len(cs) // 2
            some = TMK.mpo_linear_bwd_cores(cs, x, dy, [k != central for k in range(len(cs))])
            assert some[central] is None
            assert all(torch.equal(a, b) for k, (a, b) in enumerate(zip(some, got))
                       if k != central)
            monkeypatch.setattr(TMK, "BWD_STACK_SCRATCH", 2 * plan.workspace)
            grouped = TMK.mpo_linear_bwd_cores(cs, x, dy)
            monkeypatch.undo()
            assert TMK.mpo_linear_bwd_cores.launch_sets == 2
            assert TMK.mpo_linear_bwd_cores.workspace_bytes == 2 * plan.workspace
            assert all(torch.equal(a, b) for a, b in zip(grouped, got)), (shapes, m)
        dims = (ctypes.c_int * (4 * len(shapes)))(*[d for s in shapes for d in s])
        ws = TMK._bwd_lib().mpo_linear_bwd_workspace(dims, len(shapes), plan.split,
                                                     plan.blocks // plan.cluster, e)
        assert 4 * ws == e * plan.workspace


# the matrices the autotuner races the forward's row tiles at on the card:
# the tensor-core route (bert-base's attention matrix and w_up, both dtypes)
# and csrc/mpo_linear.cu (whisper-tiny's attention matrix, float32)
TUNED_CARD = {"attn": (lambda: _matrices()["attn"], ("bfloat16", "float32")),
              "w_up": (lambda: _matrices()["w_up"], ("bfloat16",)),
              "whisper-tiny attn": (lambda: _port_shapes("whisper-tiny", "encoder", "attn",
                                                         "wq"), ("float32",))}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TUNED_CARD))
def test_cuda_every_tuned_tile_matches_plain(cuda, name):
    """Each row tile the autotuner races (``autotune._block_m_candidates``)
    at 8, 100 and 2048 rows, forward and backward through ``MPOLinearFn``:
    the forward within the forward's tolerance of the plain version (bf16
    2^-7, float32 1e-4 of the largest output, grown as the root of I past
    3072 terms), launched at that tile, its plan's shared memory and
    workspace the CUDA source's; dL/dx (at the tile where the swapped
    cores' kernel takes it) and the core gradients within the same
    tolerance of the plain versions' (``mpo_linear_bwd_cores_plain``)."""
    from repro_torch.kernels import autotune as TA
    get, dtypes = TUNED_CARD[name]
    shapes = tuple(tuple(s) for s in get())
    i_dim = math.prod(c[1] for c in shapes)
    j_dim = math.prod(c[2] for c in shapes)
    dims = (ctypes.c_int * (4 * len(shapes)))(*[d for s in shapes for d in s])
    rng = np.random.default_rng(9)
    sigma = (1.0 / i_dim / math.prod(c[3] for c in shapes[:-1])) ** (1 / (2 * len(shapes)))
    for dtype in dtypes:
        tdt = getattr(torch, dtype)
        tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-4 * math.sqrt(max(i_dim, 3072) / 3072)
        code = TMK.DTYPES[tdt]
        cores = [torch.from_numpy((rng.standard_normal(s) * sigma).astype(np.float32))
                 .to(cuda, tdt) for s in shapes]
        route = TMK.forward_kernel(shapes, dtype)
        for m in (8, 100, 2048):
            tiles = TA._block_m_candidates(shapes, m, "train", dtype, "cuda")
            assert tiles, (name, dtype, m)
            x = torch.from_numpy(rng.standard_normal((m, i_dim)).astype(np.float32)).to(cuda, tdt)
            dy = torch.from_numpy(rng.standard_normal((m, j_dim)).astype(np.float32)).to(cuda, tdt)
            ref = TMK.mpo_linear_plain(cores, x).float()
            dx_ref = TMK.mpo_linear_plain(TM.transpose_cores(cores), dy).float()
            dc_ref = TMK.mpo_linear_bwd_cores_plain(cores, x, dy, [True] * len(cores))
            for bm in tiles:
                plan = TMK.forward_plan(shapes, m, dtype, bm)
                assert plan.bm == bm
                if route == "mma":
                    smem = TMK._mma_lib().mpo_linear_mma_smem(dims, len(shapes), plan.split,
                                                              bm, code)
                    ws = 4 * TMK._mma_lib().mpo_linear_mma_workspace(
                        dims, len(shapes), plan.split, m, plan.splits, 1, code)
                else:
                    smem = TMK._lib().mpo_linear_fwd_smem(dims, len(shapes), plan.split, bm,
                                                          plan.ch, plan.lq)
                    ws = TMK._lib().mpo_linear_fwd_workspace(dims, len(shapes), plan.split, m,
                                                             plan.splits, 1)
                assert (smem, ws) == (plan.smem, plan.workspace), (name, dtype, m, bm)
                xs = x.clone().requires_grad_()
                cs = [c.clone().requires_grad_() for c in cores]
                y = TMK.MPOLinearFn.apply(xs, bm, *cs)
                grads = torch.autograd.grad(y, (xs, *cs), dy)
                torch.cuda.synchronize()
                for got, want, what in ((y, ref, "y"), (grads[0], dx_ref, "dx"),
                                        *((g, w, f"d core {k}") for k, (g, w) in
                                          enumerate(zip(grads[1:], dc_ref)))):
                    err = (got.float() - want.float()).abs().max().item()
                    assert err <= tol * want.float().abs().max().item(), (
                        name, dtype, m, bm, what, err)
