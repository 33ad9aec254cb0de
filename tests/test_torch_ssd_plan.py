"""The chunked SSD scan's plan and its three launches on the CPU
(``repro_torch/kernels/ssd_scan.py``: ``_ssd_plan``; ``csrc/ssd_scan.cu``).

The kernel runs only on the card, but what it computes is laid out here:
``_replay`` replays its three launches in torch, float32 — the chunk's
cumulative sum as the kernel's warp scan forms it (4 rows a lane, then a
scan over 32 lanes), launch 1's chunk states Bᵀ(x ∘ s) with the operands
split into the kernel's bf16 terms (bf16: the f32-valued operand as a hi/lo
pair; float32: every operand as three terms, the products with
``ta + tb <= 2``), launch 2's pass over a NaN-filled scratch overwritten in
place, launch 3's C·Bᵀ once a chunk and G' = (C·Bᵀ) ∘ exp(dac_i − dac_j) dt_j
formed elementwise.  It is held against the reference's ``ssd_chunked`` and
the Pallas ``ssd_scan`` (interpret mode) at ``tests/test_kernels.py``'s
shapes, and against the plain version at mamba2-130m's head geometry, with
``chip_smoke.py``'s tolerances: y within ``TOL`` of its largest magnitude
(float32 1e-4; bf16 one bf16 step at the largest value, doubled), the final
state within ``STATE_TOL`` (1e-4) of its largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro.models.mamba import ssd_chunked as j_ssd_chunked
from repro_torch.kernels import ssd_scan as TSSD

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}     # chip_smoke.py's TOL
STATE_TOL = 1e-4                                    # chip_smoke.py's STATE_TOL


def _inputs(b, s, h, p, n, dtype="float32", seed=0, dt_shift=0.0, a_log=None):
    """tests/test_kernels.py's SSD inputs, drawn with numpy; in bf16, x, dt,
    B and C are bf16 values for every side."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) + dt_shift)).astype(np.float32)
    al = (rng.standard_normal(h) * 0.5).astype(np.float32) if a_log is None else \
        np.full(h, a_log, np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    d = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    if dtype == "bfloat16":
        x, dt, bm, cm = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                         for a in (x, dt, bm, cm))
    return x, dt, al, bm, cm, d


def _torch(args, dtype):
    x, dt, al, bm, cm, d = (torch.from_numpy(a) for a in args)
    tdt = getattr(torch, dtype)
    return x.to(tdt), dt, al, bm.to(tdt), cm.to(tdt), d


def _terms(v: torch.Tensor, k: int) -> list:
    """f32 ``v`` as k bf16 terms, each bf16 of what the terms before it leave."""
    out = []
    for _ in range(k):
        t = v.to(torch.bfloat16).float()
        out.append(t)
        v = v - t
    return out


def _prod(eq: str, a_terms: list, b_terms: list) -> torch.Tensor:
    """The products the kernel takes, term pairs with ``ta + tb <= 2``,
    smallest first; each product of bf16 values is exact in f32."""
    out = None
    for ta in reversed(range(len(a_terms))):
        for tb in reversed(range(len(b_terms))):
            if ta + tb <= 2:
                p = torch.einsum(eq, a_terms[ta], b_terms[tb])
                out = p if out is None else out + p
    return out


def _chunk_cumsum(a: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """``chunk_cumsum`` in the CUDA source over the last axis (q <= 128):
    da = a * dt rounded, 4 rows a lane summed in order, an inclusive scan
    over the 32 lanes in five shuffle steps, dac = (inclusive - run) + v;
    every step one f32 rounding."""
    q = dt.shape[-1]
    da = torch.zeros(*dt.shape[:-1], 128)
    da[..., :q] = a[..., None] * dt
    v = da.reshape(*dt.shape[:-1], 32, 4)
    runs = [v[..., 0]]
    for t in range(1, 4):
        runs.append(runs[-1] + v[..., t])
    v = torch.stack(runs, -1)
    run = v[..., 3]
    incl = run.clone()
    lane = torch.arange(32)
    for off in (1, 2, 4, 8, 16):
        up = torch.zeros_like(incl)
        up[..., off:] = incl[..., :-off]
        incl = torch.where(lane >= off, incl + up, incl)
    return ((incl - run)[..., None] + v).reshape(*dt.shape[:-1], 128)[..., :q]


def _replay(x, dt, a_log, b, c, d_skip, chunk, factored=False):
    """The three launches of ``csrc/ssd_scan.cu``, replayed in torch:
    ``(y in x's dtype, final state, dac)``.  ``factored`` forms the causal
    decay as exp(dac_i) · exp(-dac_j) instead (what the kernel must not)."""
    nt, wt = TSSD.SSD_TERMS["float32" if x.dtype == torch.float32 else "bfloat16"]
    bs, s, h, p = x.shape
    n = b.shape[-1]
    q = TSSD.chunk_len(s, chunk)
    nc = s // q
    xc = x.float().reshape(bs, nc, q, h, p).permute(0, 1, 3, 2, 4)       # (B, NC, H, q, P)
    dtc = dt.float().reshape(bs, nc, q, h).permute(0, 1, 3, 2)           # (B, NC, H, q)
    bc = b.float().reshape(bs, nc, q, n)
    cc = c.float().reshape(bs, nc, q, n)
    a = -torch.exp(a_log.float())
    dac = _chunk_cumsum(a[None, None, :].expand(bs, nc, h), dtc)          # launches 1 and 3

    # launch 1: S = B^T (x o s), s_j = dt_j exp(dac_last - dac_j); the chunk's decay
    sj = dtc * torch.exp(dac[..., -1:] - dac)
    ws = torch.full((bs, nc, h, n, p), float("nan"))
    ws[...] = _prod("bcjn,bchjp->bchnp", _terms(bc, nt), _terms(xc * sj[..., None], wt))
    decay = torch.exp(dac[..., -1])                                      # (B, NC, H)

    # launch 2: the carried state over each chunk's S, in place
    run = torch.zeros(bs, h, n, p)
    for ci in range(nc):
        sc = ws[:, ci].clone()
        ws[:, ci] = run
        run = run * decay[:, ci, :, None, None] + sc
    assert not torch.isnan(ws).any()

    # launch 3: C B^T once a chunk; per head G' and y
    cb = _prod("bcin,bcjn->bcij", _terms(cc, nt), _terms(bc, nt))        # (B, NC, q, q)
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool))
    if factored:
        lmat = torch.exp(dac)[..., :, None] * torch.exp(-dac)[..., None, :]
    else:
        lmat = torch.exp(torch.where(tri, dac[..., :, None] - dac[..., None, :], 0.0))
    g = torch.where(tri, cb[:, :, None] * (lmat * dtc[..., None, :]), 0.0)
    y = _prod("bchij,bchjp->bchip", _terms(g, wt), _terms(xc, nt))
    off = _prod("bcin,bchnp->bchip", _terms(cc, nt), _terms(ws, wt)) * torch.exp(dac)[..., None]
    y = (off + y) + xc * d_skip.float()[None, None, :, None, None]
    y = y.permute(0, 1, 3, 2, 4).reshape(bs, s, h, p)
    return y.to(x.dtype), run, dac


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all(), what
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (what, err, np.abs(ref).max())


# --------------------------------------------------------------------------
# (a) the plan at the corners of what the kernel takes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("q", [1, 16, 100, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_plan_corners_fit_and_size_the_scratch(q, dtype):
    """Every launch's shared memory fits one block (227 KB) at q in {1, 16,
    100, 128}, N in {8, 16, 128}, P in {8, 16, 64}; the scratch is the f32
    chunk states B·NC·H·N·P·4 plus the decays B·NC·H·4; the group divides H
    and the grids cover every (batch, chunk, group) and state element; an SM
    holds at least one block of launch 3."""
    b, h, nc = 2, 24, 3
    for n in (8, 16, 128):
        for p in (8, 16, 64):
            plan = TSSD._ssd_plan(b, nc * q, h, p, n, q, dtype)
            assert max(plan.smem) <= TSSD.SMEM_LIMIT, (n, p, plan)
            assert TSSD._ssd_resident(q, n, p, plan.group, dtype) >= 1
            assert plan.smem[1] == 0
            assert plan.workspace == b * nc * h * n * p * 4 + b * nc * h * 4
            assert 1 <= plan.group <= TSSD.SSD_GMAX and h % plan.group == 0
            assert plan.grids[0] == plan.grids[2] == b * nc * (h // plan.group)
            per = TSSD.SSD_PASS * (4 if n * p % 4 == 0 else 1)
            assert plan.grids[1] * per >= b * h * n * p


def test_ssd_plan_at_the_path_shapes():
    """mamba2-130m's phase-2 cases: 25.2 MB of scratch at 8 x 512 and 1 x
    4096; in bf16 the group leaves no SM idle (256 / 192 / 256 blocks on 132
    SMs, two resident an SM); float32 (one block an SM) takes the groups
    its cost model prefers."""
    cases = {(8, 512): (3, 6), (8, 100): (1, 2), (1, 4096): (3, 6)}
    for (b, s), groups in cases.items():
        q = min(128, s)
        for dtype, group in zip(("bfloat16", "float32"), groups):
            plan = TSSD._ssd_plan(b, s, 24, 64, 128, q, dtype)
            assert plan.group == group, (b, s, dtype, plan)
            if dtype == "bfloat16":
                assert plan.grids[2] >= TSSD.SSD_SMS
        if s != 100:
            assert TSSD._ssd_plan(b, s, 24, 64, 128, q).workspace == 25_168_896


# --------------------------------------------------------------------------
# (b) the staged replay against the reference, the Pallas kernel and the plain version
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 32, 2, 8, 8), (2, 64, 3, 8, 16), (2, 128, 4, 16, 32)])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_replay_matches_reference_and_pallas(shape, chunk, dtype):
    args = _inputs(*shape, dtype=dtype)
    y, state, _ = _replay(*_torch(args, dtype), chunk)
    jdt = getattr(jnp, dtype)
    jargs = [jnp.asarray(a) for a in args]
    for k in (0, 1, 3, 4):
        jargs[k] = jargs[k].astype(jdt)
    ry, rstate = j_ssd_chunked(*jargs, chunk)
    _close(y.float(), ry, TOL[dtype], "y vs ssd_chunked")
    _close(state, rstate, STATE_TOL, "state vs ssd_chunked")
    y_pallas = j_ssd_scan(*jargs, chunk=chunk, interpret=True)
    _close(y.float(), y_pallas, TOL[dtype], "y vs Pallas ssd_scan")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_replay_matches_plain_at_mamba2_head_geometry(dtype):
    """B = 1, S = 512 (4 chunks of 128), H = 24, P = 64, N = 128."""
    targs = _torch(_inputs(1, 512, 24, 64, 128, dtype=dtype, seed=1, dt_shift=-4.0), dtype)
    y, state, _ = _replay(*targs, 128)
    ry, rstate = TSSD.ssd_scan_plain(*targs, 128)
    assert y.dtype == ry.dtype
    _close(y.float(), ry.float(), TOL[dtype], "y vs ssd_scan_plain")
    _close(state, rstate, STATE_TOL, "state vs ssd_scan_plain")


# --------------------------------------------------------------------------
# (c) decays that a factored form would overflow
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_replay_stays_finite_where_dac_falls_below_minus_100(dtype):
    """dt ~ softplus(N(3, 1)) and a_log = 1: dac falls to about -300 within a
    chunk of 32.  The replay (exp of differences) stays finite and matches
    the reference and the plain version; the factored exp(dac_i) exp(-dac_j)
    overflows (exp(300) is inf in f32) and poisons y."""
    args = _inputs(1, 64, 2, 8, 16, dtype=dtype, seed=2, dt_shift=3.0, a_log=1.0)
    targs = _torch(args, dtype)
    y, state, dac = _replay(*targs, 32)
    assert dac.min() < -100
    ry, rstate = TSSD.ssd_scan_plain(*targs, 32)
    _close(y.float(), ry.float(), TOL[dtype], "y vs ssd_scan_plain")
    _close(state, rstate, STATE_TOL, "state vs ssd_scan_plain")
    jargs = [jnp.asarray(a) for a in args]
    jy, jstate = j_ssd_chunked(*jargs, 32)
    _close(y.float(), jy, TOL[dtype], "y vs ssd_chunked")
    yf, _, _ = _replay(*targs, 32, factored=True)
    assert not torch.isfinite(yf.float()).all()
