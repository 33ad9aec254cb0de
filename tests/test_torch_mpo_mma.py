"""The bfloat16 MPO-linear forward (``csrc/mpo_linear_mma.cu``): its launch
plan on the CPU, and the kernel against its plain version on the card.

``_mma_plan`` is pure Python, so the CPU tests hold what the engine's gate
admits at bert-base and mamba2-130m widths, the shared memory and scratch
each launch takes, and the split of I at few rows.  The ``cuda`` tests
(skipped without a card) hold the kernel against ``mpo_linear_plain`` at
``2**-7`` of the largest output: both round one f32 sum to bf16 once, in
another order, and the hi/lo pair carries W to ~2^-16 relative, so one bf16
step (2^-8) of the largest output, doubled, bounds the gap."""

import math

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.layers import cores_to_list
from repro_torch.kernels import mpo_linear as TMK
from repro_torch.models import mamba as TMB
from repro_torch.models import model as TModel


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


@pytest.mark.parametrize("name", ["attn", "w_up", "w_down", "in_proj", "out_proj", "head"])
def test_mma_plan_admits_the_models_matrices(name):
    shapes = _matrices()[name]
    assert _matrices()["head"][0] == (1, 3, 197, 48)
    for sh in (shapes, _swap(shapes)):
        assert TMK.kernel_eligible(sh, dtype="bfloat16"), (name, sh)
        assert TMK.kernel_eligible(sh, dtype="bfloat16", train=True), (name, sh)
        i_dim = math.prod(c[1] for c in sh)
        j_dim = math.prod(c[2] for c in sh)
        for m in (1, 8, 64, 100, 2048, 4096):
            plan = TMK._mma_plan(tuple(sh), m)
            assert plan is not None and plan.smem <= TMK.SMEM_LIMIT, (name, m, plan)
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


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["attn", "w_up", "w_down", "in_proj", "attn^T"])
def test_cuda_mma_matches_plain(cuda, name):
    mats = _matrices()
    shapes = _swap(mats["attn"]) if name == "attn^T" else mats[name]
    rng = np.random.default_rng(0)
    # each core's entries scaled so W's entries are O(1 / sqrt(I))
    i_dim = math.prod(c[1] for c in shapes)
    sigma = (1.0 / i_dim / math.prod(c[3] for c in shapes[:-1])) ** (1 / (2 * len(shapes)))
    cores = [torch.from_numpy((rng.standard_normal(s) * sigma).astype(np.float32))
             .to(cuda, torch.bfloat16) for s in shapes]
    j_dim = math.prod(c[2] for c in shapes)
    for m in (1, 8, 100, 2048):
        x = torch.from_numpy(rng.standard_normal((m, i_dim)).astype(np.float32)).to(
            cuda, torch.bfloat16)
        launches, f32 = TMK.mpo_linear_mma.launches, TMK.mpo_linear.launches
        y = TMK.mpo_linear(cores, x)
        again = TMK.mpo_linear(cores, x)
        torch.cuda.synchronize()
        assert TMK.mpo_linear_mma.launches == launches + 2
        assert TMK.mpo_linear.launches == f32                  # not the f32 kernel
        assert torch.equal(y, again), (name, m)                # same bits
        assert 4 * TMK.mpo_linear_mma.workspace_bytes < 2 * i_dim * j_dim
        ref = TMK.mpo_linear_plain(cores, x).float()
        err = (y.float() - ref).abs().max().item()
        assert err <= 2.0 ** -7 * ref.abs().max().item(), (name, m, err)
        assert y.dtype == torch.bfloat16 and tuple(y.shape) == (m, j_dim)
