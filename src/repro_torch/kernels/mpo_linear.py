"""Fused, differentiable MPO-linear: ``y = x @ W(cores)`` with W rebuilt on
chip and never written to device memory, forward and backward.

Three CUDA kernels replace the Pallas TPU kernels of
``repro/kernels/mpo_linear.py``:

* ``mpo_linear_mma`` (``csrc/mpo_linear_mma.cu``) replaces ``_fwd_call`` /
  ``_fwd_kernel`` in both dtypes.  The core chain is split at a bond s,
  ``W[ip, is, jp, js] = sum_d L[ip, jp, d] R[d, is, js]``; R is contracted
  once a call, each block rebuilds W stages in f32 from R and the prefix
  vectors L and multiplies them on the tensor cores (``mma.sync``, bf16 in,
  f32 accumulate), each f32 operand entering as bf16 terms: in bfloat16 W
  as the pair ``bf16(W)`` + ``bf16(W - bf16(W))``, in float32 x and W as
  three terms each (six products, ~24 bits); few rows split I across
  blocks and sum the f32 partials in a second pass.
* ``mpo_linear_cuda_core`` (``csrc/mpo_linear.cu``; the name is the route's,
  ``"cuda_core"``) is the float32 forward for the core shapes that plan
  refuses: whisper-tiny's layer matrices, zamba2-7b's shared attention,
  gemma2-27b's, nemotron-4-15b's and llava-next-34b's FFN, the vocabulary
  heads no bond tiles, the smoke configs' narrow matrices.  Digit groups
  are padded in shared memory so any shape tiles; each block keeps R there,
  forms L for groups of stages in one pass over core s-1's rows, keeps W
  resident as three bf16 terms across a group of row tiles, and multiplies
  on the tensor cores with the same six-product float32 arithmetic;
  ``_narrow_plan`` picks the launch, few rows split I across blocks.
  ``forward_kernel`` names the kernel a call takes, from the core shapes and
  dtype alone; ``mpo_linear`` is the entry point of both.
* ``mpo_linear_bwd_cores`` (``csrc/mpo_linear_bwd.cu``) replaces
  ``_bwd_cores_call`` / ``_bwd_cores_kernel`` in three launches a call:
  the chain vectors once per distinct prefix and suffix of digit pairs;
  tiles of ``dW = x^T dy`` on the tensor cores (float32 as three bf16
  terms), kept in shared memory only and pulled back there into dL and the
  block's share of dR, the shares summed across a thread-block cluster;
  then one epilogue that pulls dL and dR back through the prefix and suffix
  cores.  The plan, the scratch layout, the index maps and the small
  products of the chains and the epilogue (``_bwd_plan``, ``_bwd_jobs``)
  are built here, so the CPU tests replay them.  No atomics: two runs give
  the same bits.

All three also take a stack of E matrices of one shape, the experts of a
MoE layer (cores ``(E, d0, i, j, d1)``, x ``(E, M, I)``): the grid gains the
expert and the plan is the one matrix's at M rows, so each expert's results
are its matrix's run alone.  A forward over a stack is one launch; the
cores backward one launch set, or one a group of experts where the stack's
scratch would pass ``BWD_STACK_SCRATCH``.

``MPOLinearFn`` is the autograd function around them (the reference's
``_mpo_linear`` custom VJP): ``dL/dx`` is the forward over i/j-swapped
cores, ``dL/dcores`` the backward kernel.  The forwards take a row tile
(``block_m``: ``MMA_BM``, ``NARROW_BM``) where the autotuner
(``kernels/autotune.py``) has measured one, else their plan's own
(``forward_plan``).  Each wrapper launches its kernel
for CUDA tensors and takes its plain version only for CPU tensors.
``kernel_eligible`` is the engine's gate: it admits what the kernel of the
activation dtype handles (the TPU's 8 x 128 tile alignment and 16 MiB VMEM
budget do not apply on Hopper); with ``train=True`` both orientations and
the backward must fit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Sequence

import torch

from repro_torch.core import mpo
from repro_torch.kernels import _build

MAXN = 8                             # cores a matrix, at most (every kernel)
SMEM_LIMIT = 227 * 1024              # dynamic shared memory one block may use
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# must match csrc/mpo_linear_mma.cu: the output tile's columns, the rows of
# I a stage, the bf16 x and W stage row pitches, and the bf16 terms x and W
# enter the products as
MMA_BN, MMA_BK = 128, 32
MMA_XP, MMA_WP = MMA_BK + 8, MMA_BN + 8
MMA_TERMS = {"bfloat16": (1, 2), "float32": (3, 3)}
# the row tile whose shared memory decides which bonds the plan takes: bf16
# the largest (128); float32's stages are larger, so a bond it takes must fit
# at 64 rows and runs 128 only where that fits too
MMA_FIT_BM = {"bfloat16": 128, "float32": 64}
MMA_SMS = 132                        # the H100's SMs: split I up to two waves
SPLIT_M = 64                         # at most this many rows: I split across blocks
MMA_BM = (16, 64, 128)               # the row tiles csrc/mpo_linear_mma.cu is built for


@dataclasses.dataclass(frozen=True)
class MmaPlan:
    split: int          # bond s of the L / R split
    bm: int             # rows an output tile: 16, 64 or 128
    tc: int             # jp columns a rebuild patch: 4 or 2
    splits: int         # S, blocks that share one tile's stages of I
    smem: int           # dynamic shared memory of the main kernel, bytes
    workspace: int      # bytes of scratch: R, P, then the [S, M, J] f32 partials (a
                        # matrix's: a stack of E takes E times it)


def _mma_geometry(shapes: Sequence[tuple], s: int, dtype: str = "bfloat16") -> dict | None:
    """The stage and tile geometry of bond s, as ``make_args`` in the CUDA
    source derives it, or None when the kernel cannot take it: I in whole
    16-byte chunks of x (8 bf16, 4 floats), whole 4-row patches of is that
    divide or are divided by a stage, whole js groups in a tile and at least
    two jp a tile."""
    i_dim = math.prod(c[1] for c in shapes)
    i_s = math.prod(c[1] for c in shapes[s:])
    j_s = math.prod(c[2] for c in shapes[s:])
    chunk = 8 if dtype == "bfloat16" else 4
    if i_dim % chunk or i_s % 4 or (i_s % MMA_BK and MMA_BK % i_s) or MMA_BN % j_s:
        return None
    njq = MMA_BN // j_s
    if njq < 2:
        return None
    isb = min(i_s, MMA_BK)
    j_dim = math.prod(c[2] for c in shapes)
    # P: the prefix cores 0..s-2 contracted for every (ip, jp) digit pair
    p = 1 if s == 1 else (i_dim // i_s // shapes[s - 1][1] * (j_dim // j_s // shapes[s - 1][2])
                          * shapes[s - 1][0])
    return dict(ds=shapes[s][0], i_s=i_s, j_s=j_s, nq=MMA_BK // isb, njq=njq,
                tc=4 if njq % 4 == 0 else 2, p=p)


def _mma_smem_bytes(g: dict, bm: int, dtype: str = "bfloat16") -> int:
    """``mma_smem`` in the CUDA source: R, two x stages (bf16 at the padded
    pitch, f32 at ``MMA_BK`` floats), two L buffers, in float32 the three
    bf16 x terms, and the bf16 W term stages."""
    nx, nw = MMA_TERMS[dtype]
    lt = -(-4 * g["nq"] * g["ds"] * g["njq"] // 16) * 16
    xstage = 2 * MMA_XP if dtype == "bfloat16" else 4 * MMA_BK
    xterms = 2 * nx * bm * MMA_XP if dtype == "float32" else 0
    return (4 * g["ds"] * g["i_s"] * g["j_s"] + 2 * xstage * bm + 2 * lt + xterms
            + 2 * nw * MMA_BK * MMA_WP)


@functools.lru_cache(maxsize=None)
def _mma_split(shapes: tuple, dtype: str = "bfloat16") -> int | None:
    """The bond the tensor-core kernel splits at in this dtype, or None.
    Among the bonds it can take whose shared memory fits at ``MMA_FIT_BM``
    rows and whose scratch R and P stay within an eighth of a bf16 W, the
    least work a block does per stage: the W rebuild
    (``BK * BN * d_s`` FMAs, dearer per FMA with 2-column patches) and the
    prefix vectors of the stage's (ip, jp), one step through the last prefix
    core, amortized over the stages that share one ip."""
    n = len(shapes)
    if not 2 <= n <= MAXN or shapes[0][0] != 1 or shapes[-1][3] != 1:
        return None
    if any(a[3] != b[0] for a, b in zip(shapes, shapes[1:])):
        return None
    w_bytes = 2 * math.prod(c[1] for c in shapes) * math.prod(c[2] for c in shapes)
    best = None
    for s in range(1, n):
        g = _mma_geometry(shapes, s, dtype)
        if g is None or _mma_smem_bytes(g, MMA_FIT_BM[dtype], dtype) > SMEM_LIMIT:
            continue
        if 4 * (g["ds"] * g["i_s"] * g["j_s"] + g["p"]) * 8 > w_bytes:
            continue
        rebuild = MMA_BK * MMA_BN * g["ds"] * (1 + 1 / g["tc"])
        step = shapes[s - 1][0] * shapes[s - 1][3]
        prefix = g["nq"] * g["njq"] * step / max(1, g["i_s"] // MMA_BK)
        if best is None or rebuild + prefix < best[0]:
            best = (rebuild + prefix, s)
    return None if best is None else best[1]


def _mma_splits(i_dim: int, j_dim: int, m: int, bm: int) -> int:
    """S: 1 above ``SPLIT_M`` rows or when the tiles already fill two waves
    of the card; else enough splits of I's stages for about two waves, at
    most one a stage and few enough that the f32 partials stay within an
    eighth of a bf16 W (with R and P, the scratch stays under a quarter)."""
    nst = -(-i_dim // MMA_BK)
    blocks = -(-j_dim // MMA_BN) * -(-m // bm)
    if m > SPLIT_M or blocks >= 2 * MMA_SMS:
        return 1
    s = min(nst, -(-2 * MMA_SMS // blocks), max(1, i_dim // (16 * m)))
    per = -(-nst // s)
    return -(-nst // per)


@functools.lru_cache(maxsize=4096)
def _mma_plan(shapes: tuple, m: int, dtype: str = "bfloat16", bm: int = 0) -> MmaPlan | None:
    """The tensor-core kernel's launch for these core shapes at ``m`` rows
    in this dtype, or None when it cannot take the shapes.  Rows: 16 up to
    16, 64 up to ``SPLIT_M``, else 128 (float32: 64 where 128 does not fit
    shared memory).  A nonzero ``bm`` (one of ``MMA_BM``: the autotuner's
    row tile) fixes the tile, None where its shared memory does not fit;
    the splits of I are reckoned for it."""
    s = _mma_split(shapes, dtype)
    if s is None:
        return None
    g = _mma_geometry(shapes, s, dtype)
    if bm:
        if bm not in MMA_BM or _mma_smem_bytes(g, bm, dtype) > SMEM_LIMIT:
            return None
    else:
        bm = 16 if m <= 16 else 64 if m <= SPLIT_M else 128
        if _mma_smem_bytes(g, bm, dtype) > SMEM_LIMIT:
            bm = 64
    i_dim = math.prod(c[1] for c in shapes)
    j_dim = math.prod(c[2] for c in shapes)
    splits = _mma_splits(i_dim, j_dim, m, bm)
    ws = 4 * (g["ds"] * g["i_s"] * g["j_s"] + g["p"] + (splits * m * j_dim if splits > 1 else 0))
    return MmaPlan(s, bm, g["tc"], splits, _mma_smem_bytes(g, bm, dtype), ws)


# must match csrc/mpo_linear.cu: the padded output columns a tile, the
# padded rows of I a stage, the f32 x stage and bf16 W term row pitches, and
# the row tiles it is built for
NARROW_BN, NARROW_BK = 64, 32
NARROW_XP, NARROW_WP = NARROW_BK + 8, NARROW_BN + 8
NARROW_NXB = 3                       # x stage buffers
NARROW_BM = (64, 128)
NARROW_LGROUPS = (1, 2, 4, 8, 16)    # stages an L group may span
# the cost model that picks a launch (``_narrow_plan``), in SM clock cycles
# (measured on an H100 with tools/torch_narrow_fwd_profile.py --phases):
# CUDA-core multiply-adds a cycle a block
# achieves on the W rebuild, tensor-core multiply-adds a cycle a block of 8
# warps achieves on the six-term product, and the bytes a cycle one SM moves
# for a row tile's partial sums between chunks; shared memory an SM holds
NARROW_CHAIN_RATE, NARROW_MMA_RATE, NARROW_RMW_RATE = 13.0, 400.0, 6.0
NARROW_CORE_RATE = 6.0               # bytes a cycle a block streams of core rows (L, P)
NARROW_STAGE_CYCLES = 1000.0         # a row tile's stage besides its products: barriers, x wait
SM_SMEM = 228 * 1024


@dataclasses.dataclass(frozen=True)
class NarrowPlan:
    split: int          # bond s of the L / R split
    bm: int             # rows a row tile: 64 or 128
    rg: int             # row tiles a block (a row group), each against the block's W
    ch: int             # stages of I a chunk of W resident in shared memory
    lq: int             # ip an L group: its L formed in one pass over core s-1
    splits: int         # S, blocks that share one tile's stages of I
    smem: int           # dynamic shared memory of a block, bytes
    workspace: int      # bytes of scratch, one matrix's: the [S, M, J] f32 partials (S > 1)
    fast: bool          # the W stage rebuilt in 4 x 2 register patches
    vec: bool           # x copied in 16-byte chunks (I % 4 == 0, is not padded)


def _pow2ceil(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def _narrow_geometry(shapes: Sequence[tuple], s: int, groups: int = 1) -> dict:
    """The geometry of bond s as ``make_args`` in ``csrc/mpo_linear.cu``
    derives it, with L groups of ``groups`` stages' ip (``lq``): is and js
    padded (a power of two up to a stage's 32 rows / a tile's 64 columns,
    else a multiple of them), the ip a stage and jp a tile hold, the ipp an
    L group and the jpp a tile span at most (P's rows), stages and tiles."""
    i_dim = math.prod(c[1] for c in shapes)
    j_dim = math.prod(c[2] for c in shapes)
    i_s = math.prod(c[1] for c in shapes[s:])
    j_s = math.prod(c[2] for c in shapes[s:])
    bk, bn = NARROW_BK, NARROW_BN
    isp = _pow2ceil(i_s) if i_s <= bk else -(-i_s // bk) * bk
    jsp = _pow2ceil(j_s) if j_s <= bn else -(-j_s // bn) * bn
    nq, njq = bk // min(isp, bk), bn // min(jsp, bn)
    fi, fo = shapes[s - 1][1], shapes[s - 1][2]
    dmax = max(c[0] for c in shapes)
    lq = groups * nq
    return dict(i_s=i_s, j_s=j_s, isp=isp, jsp=jsp, nq=nq, njq=njq, lq=lq,
                npp=1 if s == 1 else min(lq, (lq - 1) // fi + 2),
                npq=1 if s == 1 else min(njq, (njq - 1) // fo + 2),
                ds=shapes[s][0], dpre=1 if s == 1 else shapes[s - 1][0], dmax=dmax,
                nst=-(-(i_dim // i_s) * isp // bk),
                jtiles=-(-(j_dim // j_s) * jsp // bn), fast=isp % 4 == 0 and njq % 2 == 0,
                vec=isp == i_s and i_dim % 4 == 0)


def _narrow_smem_bytes(g: dict, bm: int, ch: int = 1) -> int:
    """``fwd_smem`` in the CUDA source: the three f32 x stage buffers, ``ch``
    stages of the three bf16 W term tiles, R at the padded pitches, the L
    group's L, P and the two chain buffers of P's steps, each rounded to 16
    bytes; more than any block has where R's chain (two vectors of the
    largest bond at least, in the x and W region) would not fit."""
    r16 = lambda b: -(-b // 16) * 16
    xw = r16(NARROW_NXB * 4 * bm * NARROW_XP) + r16(ch * 6 * NARROW_BK * NARROW_WP)
    if xw < 8 * g["dmax"]:
        return 1 << 40
    chain = g["npp"] * g["npq"] * g["dmax"]
    return (xw
            + r16(4 * g["ds"] * g["isp"] * g["jsp"]) + r16(4 * g["lq"] * g["ds"] * g["njq"])
            + r16(4 * g["npp"] * g["npq"] * g["dpre"]) + r16(8 * chain))


def _narrow_chain(shapes: Sequence[tuple], s: int, g: dict) -> float:
    """CUDA-core multiply-adds a block spends per W value of its tile on the
    rebuild: W itself (d_s, thrice in the one-at-a-time form), L (one step
    through core s-1 per (ip, jp) pair, for the tile's jpp), P (the chain
    through cores 0..s-2 when ipp changes) and R once over the block's I."""
    bk, bn = NARROW_BK, NARROW_BN
    step = lambda ks: sum(shapes[k][0] * shapes[k][3] for k in ks)
    fi, fo = shapes[s - 1][1], shapes[s - 1][2]
    per_l = max(1, g["isp"] // bk)                  # stages that share one L
    jpq = -(-g["njq"] // fo) if s > 1 else 1        # the tile's jpp
    lform = g["dpre"] * g["ds"] * g["nq"] * min(g["njq"], jpq * fo) / (bk * bn * per_l)
    every = max(1.0, fi * g["isp"] / bk)           # stages an ipp spans
    pchain = step(range(s - 1)) * -(-g["nq"] // fi) * jpq / (bk * bn * every)
    rchain = g["i_s"] * g["j_s"] * step(range(s, len(shapes))) / (g["nst"] * bk * bn)
    return g["ds"] * (1 if g["fast"] else 3) + lform + pchain + rchain


def _narrow_build(shapes: Sequence[tuple], s: int, g: dict) -> float:
    """SM cycles a block spends on one stage of W: ``_narrow_chain``'s
    multiply-adds at ``NARROW_CHAIN_RATE``, and the core rows its L group
    streams (core s-1 once a group of ``lq`` ip, again for each 8 of its P
    rows; core s-2 once a P vector) at ``NARROW_CORE_RATE``."""
    fi, fo = shapes[s - 1][1], shapes[s - 1][2]
    stages = max(1, g["lq"] // g["nq"]) * max(1, g["isp"] // NARROW_BK)    # a group's
    nipp = g["npp"] if s > 1 else 1
    npq = min(g["npq"], -(-g["njq"] // fo) + 1) if s > 1 else 1
    cols = (fi if nipp > 1 else g["lq"]) * (fo if npq > 1 else g["njq"]) * g["ds"]
    lbytes = 4 * g["dpre"] * cols * -(-nipp * npq // 8)
    pbytes = 4 * nipp * npq * shapes[s - 2][0] * g["dpre"] if s > 1 else 0
    chain = NARROW_BK * NARROW_BN * _narrow_chain(shapes, s, g) / NARROW_CHAIN_RATE
    return chain + (lbytes + pbytes) / (stages * NARROW_CORE_RATE)


@functools.lru_cache(maxsize=None)
def _narrow_split(shapes: tuple) -> int | None:
    """The bond ``csrc/mpo_linear.cu`` splits at, or None when it cannot
    take the shapes: among the bonds whose block fits shared memory at 64
    rows and one stage of W, the least work per W value: the rebuild
    (``_narrow_chain``) and the six-term product over the padded rows and
    columns at 64 rows (at ``NARROW_MMA_RATE`` against
    ``NARROW_CHAIN_RATE``)."""
    n = len(shapes)
    if not 2 <= n <= MAXN or shapes[0][0] != 1 or shapes[-1][3] != 1:
        return None
    if any(a[3] != b[0] for a, b in zip(shapes, shapes[1:])) or min(min(c) for c in shapes) < 1:
        return None
    if math.prod(c[1] for c in shapes) > 2 ** 30 or math.prod(c[2] for c in shapes) > 2 ** 30:
        return None
    best = None
    for s in range(1, n):
        g = _narrow_geometry(shapes, s)
        if _narrow_smem_bytes(g, NARROW_BM[0]) > SMEM_LIMIT:
            continue
        pad = g["isp"] * g["jsp"] / (g["i_s"] * g["j_s"])
        cost = (_narrow_chain(shapes, s, g)
                + 64 * 6 * pad * NARROW_CHAIN_RATE / NARROW_MMA_RATE)
        if best is None or cost < best[0]:
            best = (cost, s)
    return None if best is None else best[1]


def _narrow_splits(i_dim: int, m: int, blocks: int, nst: int, slots: int = 2 * MMA_SMS) -> int:
    """S: 1 when the blocks already fill two waves of the card; else at
    least enough splits of I's stages for two waves (or as many as the
    stages and the workspace allow: the [S, M, J] f32 partials stay below a
    quarter of a bf16 W, S * M * J * 4 < I * J / 2, so S < I / (8 M)), and
    up to that cap the S whose rounds of ``slots`` co-resident blocks take
    the fewest stages a block (two stages added for a block's set-up)."""
    if blocks >= 2 * MMA_SMS:
        return 1
    cap = min(nst, max(1, -(-i_dim // (8 * m)) - 1))
    lo = min(cap, -(-2 * MMA_SMS // blocks))
    best = None
    for s in range(lo, cap + 1):
        per = -(-nst // s)
        s = -(-nst // per)                   # whole stages a split
        t = -(-blocks * s // slots) * (per + 2)
        if best is None or t < best[0]:
            best = (t, s)
    return best[1]


@functools.lru_cache(maxsize=4096)
def _narrow_plan(shapes: tuple, m: int, bm: int = 0) -> NarrowPlan | None:
    """``csrc/mpo_linear.cu``'s launch for these core shapes at ``m`` rows,
    or None when it cannot take the shapes.  Row tiles of 64 up to 64 rows,
    else 128 where that fits.  L groups of up to ``NARROW_LGROUPS`` stages'
    ip (each pass over core s-1's rows serves them all), as many as fit.
    One row tile: one block a column tile (and a split of I,
    ``_narrow_splits``), its accumulator in registers, one stage of W at a
    time, the L group the largest that leaves room for two blocks an SM.
    More: the row tile, the L group, the chunk of resident W (as many stages
    as fit beside them, up to all) and the row group (``rg`` row tiles a
    block) that ``NARROW_*_RATE`` reckon fastest (``_narrow_build``): a
    block rebuilds W once for its group, fewer groups rebuild less but fill
    fewer SMs, larger L groups stream the core rows fewer times but leave
    less room for resident W, and a group of more than one row tile moves
    its partial sums between chunks.  A nonzero ``bm`` (one of
    ``NARROW_BM``: the autotuner's row tile) fixes the row tile and the
    rest is chosen for it as above; None where no launch fits at it."""
    s = _narrow_split(shapes)
    if s is None or (bm and bm not in NARROW_BM):
        return None
    g1 = _narrow_geometry(shapes, s)
    i_dim = math.prod(c[1] for c in shapes)
    j_dim = math.prod(c[2] for c in shapes)
    tiles = (bm,) if bm else NARROW_BM
    if not bm:
        bm = 64 if m <= 64 or _narrow_smem_bytes(g1, 128) > SMEM_LIMIT else 128
    mtiles = -(-max(m, 1) // bm)
    nst = g1["nst"]
    geo = lambda k: _narrow_geometry(shapes, s, k)
    if mtiles == 1:
        fits = [k for k in NARROW_LGROUPS if k <= nst and _narrow_smem_bytes(geo(k), bm) <= SMEM_LIMIT]
        if not fits:
            return None
        two = [k for k in fits if _narrow_smem_bytes(geo(k), bm) <= SM_SMEM // 2 - 1024]
        g = geo(max(two or fits))
        smem = _narrow_smem_bytes(g, bm)
        splits = _narrow_splits(i_dim, max(m, 1), g["jtiles"], nst,
                                MMA_SMS * max(1, SM_SMEM // (smem + 1024)))
        ws = 4 * splits * m * j_dim if splits > 1 else 0
        return NarrowPlan(s, bm, 1, 1, g["lq"], splits, smem, ws, g["fast"], g["vec"])
    wst = 6 * NARROW_BK * NARROW_WP
    best = None
    for bmc in tiles:                    # row tile, L group, resident stages, row group
        mt = -(-m // bmc)
        for k in NARROW_LGROUPS:
            if k > nst:
                continue
            gk = geo(k)
            build = nst * _narrow_build(shapes, s, gk)
            ch = min(nst, (SMEM_LIMIT - _narrow_smem_bytes(gk, bmc, 0)) // wst)
            if ch < 1 or _narrow_smem_bytes(gk, bmc, ch) > SMEM_LIMIT:
                continue
            prod = nst * (bmc * NARROW_BK * NARROW_BN * 6 / NARROW_MMA_RATE
                          + NARROW_STAGE_CYCLES)
            rmw = (-(-nst // ch) - 1) * 2 * bmc * NARROW_BN * 4 / NARROW_RMW_RATE
            for rg in sorted({-(-mt // q) for q in range(1, mt + 1)}):
                c = ch if rg > 1 else 1
                smem = _narrow_smem_bytes(gk, bmc, c)
                slots = MMA_SMS * max(1, SM_SMEM // (smem + 1024))
                blocks = gk["jtiles"] * -(-mt // rg)
                t = -(-blocks // slots) * (build + rg * (prod + (rmw if rg > 1 else 0.0)))
                if best is None or t < best[0]:
                    best = (t, bmc, rg, c, smem, gk)
    if best is None:
        return None
    _, bm, rg, ch, smem, g = best
    return NarrowPlan(s, bm, rg, ch, g["lq"], 1, smem, 0, g["fast"], g["vec"])


def forward_kernel(shapes: Sequence[tuple], dtype: str) -> str | None:
    """The forward kernel ``mpo_linear`` launches for these core shapes on
    the card, from the shapes and dtype alone (never after a failure):
    ``"mma"`` (``csrc/mpo_linear_mma.cu``) wherever its plan takes them;
    for float32 shapes it refuses but ``_narrow_split`` takes,
    ``"cuda_core"`` (``csrc/mpo_linear.cu``); else None."""
    return _route(tuple(tuple(int(d) for d in s) for s in shapes), dtype)


def forward_plan(shapes: Sequence[tuple], m: int, dtype: str, block_m: int = 0):
    """The launch plan of the forward ``forward_kernel`` names for these
    core shapes at ``m`` rows (``MmaPlan`` or ``NarrowPlan``), at row tile
    ``block_m`` when nonzero (else the kernel's own choice), or None where
    that kernel cannot take them at that tile."""
    shapes = tuple(tuple(int(d) for d in s) for s in shapes)
    route = _route(shapes, dtype)
    if route == "mma":
        return _mma_plan(shapes, m, dtype, block_m)
    if route == "cuda_core":
        return _narrow_plan(shapes, m, block_m)
    return None


@functools.lru_cache(maxsize=None)
def _route(shapes: tuple, dtype: str) -> str | None:
    if dtype not in ("float32", "bfloat16"):
        return None
    if _mma_split(shapes, dtype) is not None:
        return "mma"
    if dtype == "float32" and _narrow_split(shapes) is not None:
        return "cuda_core"
    return None


def kernel_eligible(shapes: Sequence[tuple], *, dtype: str = "float32",
                    train: bool = False) -> bool:
    """Can the Hopper kernels run these core shapes in this activation dtype?

    bfloat16 runs ``csrc/mpo_linear_mma.cu``, whose bond must give whole
    stage and tile groups (``_mma_split``).  float32 admits what
    ``csrc/mpo_linear.cu`` takes: 2..8 cores and a bond whose padded R and
    the rest of a block fit one block's shared memory at 64 rows
    (``_narrow_split``; every matrix of every config in both orientations,
    the answers the kernel's first plan gave).  Of those, the shapes the tensor-core
    plan takes in float32 run ``mpo_linear_mma.cu`` and the rest
    ``mpo_linear.cu`` (``forward_kernel``): at the repository's configs the
    smoke configs' narrow matrices (W of 64 x 64 to 128 x 64: every bond's R
    and P exceed an eighth of it, or its is group is not whole 4-row
    patches), whisper-tiny's layer matrices, zamba2-7b's shared attention,
    gemma2-27b's, nemotron-4-15b's and llava-next-34b's FFN and the
    vocabulary heads no bond tiles (qwen3-14b's ``lm_head``: no bond's js
    group divides the 128-column tile; ``tests/test_torch_narrow_fwd.py``
    pins the list).
    ``train`` also needs the forward over the i/j-swapped cores (``dL/dx``)
    and the cores-backward kernel (``_bwd_plan``).  Over an expert stack the
    backward's grid is a group of experts times the plan's blocks along x
    (up to 2^31 - 1: any stack fits); the forwards' grid puts the experts
    with the row tiles (``mpo_linear.cu``: row groups) in z (at most 65535), which ``mpo_linear_mma`` and
    ``mpo_linear_cuda_core`` check at the call, where the rows are known."""
    if dtype not in ("float32", "bfloat16"):
        return False
    shapes = tuple(tuple(int(d) for d in s) for s in shapes)
    fits = ((lambda sh: _narrow_split(sh) is not None) if dtype == "float32"
            else (lambda sh: _mma_split(sh) is not None))
    if not fits(shapes):
        return False
    if not train:
        return True
    swapped = tuple((d0, j, i, d1) for d0, i, j, d1 in shapes)
    return fits(swapped) and _bwd_plan(shapes, dtype) is not None


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' working type: float32, as the kernels sum (float64
    inputs, which no kernel takes, keep float64 for ``gradcheck``)."""
    return torch.promote_types(dtype, torch.float32)


def mpo_linear_plain(cores: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The plain version: W rebuilt in f32, f32 product, one rounding to
    x's dtype — the arithmetic the kernel does, in another order.  Over a
    stack (5-D cores, x ``(E, ..., I)``) each matrix's W multiplies its own
    rows, in one batched product."""
    mpo_linear_plain.calls += 1
    acc = _acc_dtype(x.dtype)
    cores = [c.to(acc) for c in cores]
    w = (mpo.reconstruct_stacked if cores[0].dim() == 5 else mpo.reconstruct)(cores)
    y = x.reshape(*w.shape[:-2], -1, w.shape[-2]).to(acc) @ w     # ([E,] rows, J)
    return y.to(x.dtype).reshape(*x.shape[:-1], w.shape[-1])


mpo_linear_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mpo_linear")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mpo_linear_fwd.argtypes = [
        ctypes.POINTER(ptr), ctypes.POINTER(i32), i32, i32, i32, i32, i32, i32, i32, ptr, ptr,
        i32, i32, ptr, ptr]
    lib.mpo_linear_fwd.restype = i32
    lib.mpo_linear_fwd_smem.argtypes = [ctypes.POINTER(i32), i32, i32, i32, i32, i32]
    lib.mpo_linear_fwd_smem.restype = ctypes.c_long
    lib.mpo_linear_fwd_workspace.argtypes = [ctypes.POINTER(i32), i32, i32, i32, i32, i32]
    lib.mpo_linear_fwd_workspace.restype = ctypes.c_long
    return lib


@functools.lru_cache(maxsize=None)
def _mma_lib() -> ctypes.CDLL:
    lib = _build.load("mpo_linear_mma")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mpo_linear_mma_smem.argtypes = [ctypes.POINTER(i32), i32, i32, i32, i32]
    lib.mpo_linear_mma_smem.restype = ctypes.c_long
    lib.mpo_linear_mma_workspace.argtypes = [ctypes.POINTER(i32), i32, i32, i32, i32, i32, i32]
    lib.mpo_linear_mma_workspace.restype = ctypes.c_long
    lib.mpo_linear_mma_fwd.argtypes = [
        ctypes.POINTER(ptr), ctypes.POINTER(i32), i32, i32, i32, i32, i32, ptr, ptr, i32, i32,
        ptr, i32, ptr]
    lib.mpo_linear_mma_fwd.restype = i32
    return lib


def mpo_linear(cores: Sequence[torch.Tensor], x: torch.Tensor,
               block_m: int = 0) -> torch.Tensor:
    """``y[..., J] = x[..., I] @ W(cores)`` without W in device memory.

    A stack of E matrices of one shape — 5-D cores ``(E, d0, i, j, d1)``,
    x ``(E, ..., I)`` — gives y ``(E, ..., J)``, each matrix applied to its
    own rows, in one launch (planned as one matrix at its ``M`` rows).

    CPU tensors take ``mpo_linear_plain``.  CUDA tensors launch the kernel
    ``forward_kernel`` names: ``csrc/mpo_linear_mma.cu`` (``mpo_linear_mma``)
    in both dtypes, or for the float32 shapes its plan refuses
    ``csrc/mpo_linear.cu`` (``mpo_linear_cuda_core``); each wrapper counts
    its launches, one a call, stacked or not.  ``block_m`` is the row tile
    (the autotuner's verdict), 0 for the kernel's own plan.  Raises on
    anything the kernels do not take: other devices or dtypes, mixed
    dtypes, non-contiguous inputs, shapes neither takes, a row tile the
    kernel is not built for or that does not fit."""
    _build.refuse_dtensor("mpo_linear", x, *cores)
    cores = list(cores)
    if x.device.type == "cpu":
        return mpo_linear_plain(cores, x)
    rank = cores[0].dim()
    if rank not in (4, 5) or any(c.dim() != rank for c in cores):
        raise ValueError(f"mpo_linear: cores must be 4-D, or 5-D for a stack, got "
                         f"{[tuple(c.shape) for c in cores]}")
    n_stack = cores[0].shape[0] if rank == 5 else 1
    if rank == 5 and (any(c.shape[0] != n_stack for c in cores) or x.dim() < 2
                      or x.shape[0] != n_stack):
        raise ValueError(f"mpo_linear: a stack of {n_stack} matrices needs every core's and "
                         f"x's leading dim {n_stack}, got x {tuple(x.shape)}")
    shapes = tuple(tuple(c.shape[-4:]) for c in cores)
    for c in cores:
        if c.device != x.device or c.dtype != x.dtype or not c.is_contiguous():
            raise ValueError("mpo_linear: cores must be contiguous, on x's device "
                             f"and in x's dtype ({x.dtype}, {x.device})")
    if x.dtype not in DTYPES or not x.is_contiguous():
        raise ValueError(f"mpo_linear: x must be contiguous float32/bfloat16, "
                         f"got {x.dtype}")
    i_dim = math.prod(s[1] for s in shapes)
    j_dim = math.prod(s[2] for s in shapes)
    if x.shape[-1] != i_dim:
        raise ValueError(f"mpo_linear: x has {x.shape[-1]} features, W has {i_dim} rows")
    if x.device.type != "cuda":
        raise ValueError(f"mpo_linear: unsupported device {x.device}")
    m = math.prod(x.shape[1 if rank == 5 else 0:-1])
    dtype = "float32" if x.dtype == torch.float32 else "bfloat16"
    route = _route(shapes, dtype)
    if route is None:
        raise ValueError(f"mpo_linear: no {dtype} kernel takes core shapes {shapes}")
    fn = mpo_linear_mma if route == "mma" else mpo_linear_cuda_core
    return fn(cores, shapes, j_dim, m, x, n_stack, block_m)


@functools.lru_cache(maxsize=None)
def _dims(shapes: tuple):
    """The core shapes as the C entry points take them: 4 ints a core."""
    return (ctypes.c_int * (4 * len(shapes)))(*[d for s in shapes for d in s])


def mpo_linear_cuda_core(cores: list, shapes: tuple, j_dim: int, m: int,
                         x: torch.Tensor, n_stack: int = 1, block_m: int = 0) -> torch.Tensor:
    """Launches ``csrc/mpo_linear.cu`` (the float32 forward for the shapes
    the tensor-core plan of ``csrc/mpo_linear_mma.cu`` refuses; it runs on
    the tensor cores too) on the float32 inputs ``mpo_linear`` checked,
    ``n_stack`` matrices of ``shapes`` at ``m`` rows each, at row tile
    ``block_m`` (0: the plan's own) (``mpo_linear_cuda_core.launches``
    counts its launches, ``.stacked_launches`` those over a stack of more
    than one matrix; ``.workspace_bytes`` is the last call's scratch: the
    split partials, never W)."""
    plan = _narrow_plan(shapes, m, block_m)
    if plan is None or x.dtype != torch.float32:
        raise ValueError(f"mpo_linear: csrc/mpo_linear.cu does not take {x.dtype} "
                         f"core shapes {shapes} at row tile {block_m or 'of its plan'}")
    if n_stack * -(-m // (plan.bm * plan.rg)) > 65535:
        raise ValueError(f"mpo_linear: {n_stack} x {m} rows exceed the launch grid")
    y = torch.empty(*x.shape[:-1], j_dim, dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    if plan.vec and x.data_ptr() % 16:
        x = x.clone()                  # cp.async copies x in 16-byte chunks
    ws = torch.empty(n_stack * plan.workspace // 4, dtype=torch.float32, device=x.device)
    ptrs = (ctypes.c_void_p * len(cores))(*[c.data_ptr() for c in cores])
    _build.launch("mpo_linear_fwd", x, lambda stream: _lib().mpo_linear_fwd(
        ptrs, _dims(shapes), len(cores), plan.split, plan.bm, plan.rg, plan.ch, plan.lq,
        plan.splits, x.data_ptr(), y.data_ptr(), m, n_stack, ws.data_ptr(), stream))
    mpo_linear_cuda_core.launches += 1
    mpo_linear_cuda_core.stacked_launches += n_stack > 1
    mpo_linear_cuda_core.workspace_bytes = n_stack * plan.workspace
    return y


mpo_linear_cuda_core.launches = 0
mpo_linear_cuda_core.stacked_launches = 0
mpo_linear_cuda_core.workspace_bytes = 0


def mpo_linear_mma(cores: list, shapes: tuple, j_dim: int, m: int,
                   x: torch.Tensor, n_stack: int = 1, block_m: int = 0) -> torch.Tensor:
    """Launches ``csrc/mpo_linear_mma.cu`` on the inputs ``mpo_linear``
    checked, in their dtype, ``n_stack`` matrices of ``shapes`` at ``m`` rows
    each, at row tile ``block_m`` (0: the plan's own)
    (``mpo_linear_mma.launches`` counts its launches,
    ``.stacked_launches`` those over a stack of more than one matrix;
    ``mpo_linear_mma.workspace_bytes`` is the last call's scratch: each
    matrix's R, P and split-I partials, never W)."""
    dtype = "float32" if x.dtype == torch.float32 else "bfloat16"
    plan = _mma_plan(shapes, m, dtype, block_m)
    if plan is None:
        raise ValueError(f"mpo_linear: the tensor-core kernel does not take {dtype} "
                         f"core shapes {shapes} at row tile {block_m or 'of its plan'}")
    if n_stack * -(-m // plan.bm) > 65535:
        raise ValueError(f"mpo_linear: {n_stack} x {m} rows exceed the launch grid")
    y = torch.empty(*x.shape[:-1], j_dim, dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    if x.data_ptr() % 16:
        x = x.clone()                  # cp.async copies x in 16-byte chunks
    ws = torch.empty(n_stack * plan.workspace // 4, dtype=torch.float32, device=x.device)
    ptrs = (ctypes.c_void_p * len(cores))(*[c.data_ptr() for c in cores])
    _build.launch("mpo_linear_mma_fwd", x, lambda stream: _mma_lib().mpo_linear_mma_fwd(
        ptrs, _dims(shapes), len(cores), plan.split, plan.bm, plan.tc, plan.splits,
        x.data_ptr(), y.data_ptr(), m, n_stack, ws.data_ptr(), DTYPES[x.dtype], stream))
    mpo_linear_mma.launches += 1
    mpo_linear_mma.stacked_launches += n_stack > 1
    mpo_linear_mma.workspace_bytes = n_stack * plan.workspace
    return y


mpo_linear_mma.launches = 0
mpo_linear_mma.stacked_launches = 0
mpo_linear_mma.workspace_bytes = 0


# --------------------------------------------------------------------------
# cores backward
# --------------------------------------------------------------------------


# must match csrc/mpo_linear_bwd.cu: rows of M a stage and stages in flight
# (bf16 / float32), the largest R = d_s * Is * Js (R sits in each tile
# block's shared memory and its dR share in registers: 64 floats a thread),
# the dW tile shapes the plan picks from (whole is / js groups), the largest
# cluster, and the fields of one job of the job runner (sources: core k >= 0,
# BWD_ONES = the value 1, BWD_WS = the f32 workspace)
BWD_BK = {"bfloat16": 64, "float32": 32}
BWD_STAGES = {"bfloat16": 4, "float32": 2}
BWD_RMAX = 16384
BWD_TILES = ((128, 128), (128, 64), (64, 128), (64, 64))
BWD_CLUSTER = 8
BWD_KSLICE = 256                     # k a slice of the epilogue's long sums
BWD_MAXJOBS = 64                     # jobs a launch of the job runner
BWD_ONES, BWD_WS = -1, -2
JOB_FIELDS = ("step", "M", "N", "K1", "K2", "Z",
              "a_src", "a_off", "a_sz", "a_sm", "a_s1", "a_s2",
              "b_src", "b_off", "b_sz", "b_s1", "b_s2", "b_sn",
              "c_dst", "c_off", "c_sz", "c_sm", "c_sn")
BWD_KERNELS = 3                      # launches a set: chains, tiles, epilogue
# the scratch one call over an expert stack may take (5% of the H100's 80
# GB): at the full-width expert shapes one matrix's scratch is 320 MB
# (phi3.5-moe) to 509 MB (llama4-maverick), so a stack runs in groups of
# experts, one launch set a group, each reusing the scratch (``_bwd_group``)
BWD_STACK_SCRATCH = 4 * 2 ** 30


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    split: int          # bond s of the L / R split
    tr: int             # dW tile rows (of I): whole Is groups
    tc: int             # dW tile columns (of J): whole Js groups
    pairs: int          # (ip, jp) pairs a tile holds
    tiles: int
    cluster: int        # blocks a cluster: their dR partials are summed in rank order
    blocks: int         # blocks of the tile pass, each a fixed walk over tiles
    smem: int           # dynamic shared memory of the tile pass, bytes
    workspace: int      # bytes of scratch: the layout below, never dW
    phi: tuple          # float offsets of phi_1 .. phi_s (phi_s = L)
    mu: tuple           # mu_1 .. mu_s (mu_s = dL)
    rho: tuple          # rho_s .. rho_{n-1} (rho_s = R)
    lam: tuple          # lam_s .. lam_{n-1} (lam_s = dR)
    part: int           # the clusters' dR partials, [clusters][Is * Js * d_s]


def _r4(n: int) -> int:
    return -(-n // 4) * 4


def _bwd_smem_bytes(ds: int, i_s: int, j_s: int, tr: int, tc: int, dtype: str) -> int:
    """``tile_smem`` in the CUDA source: R, the tile's L rows and the is/js
    index maps, then one region the stages, the dW tile (pair-major) and
    the block's dR share take in turn.  bf16 stages are the operands; a
    float32 stage lands as f32 and is split into three bf16 terms."""
    q = i_s * j_s
    npair = (tr // i_s) * (tc // j_s)
    ns, bk = BWD_STAGES[dtype], BWD_BK[dtype]
    if dtype == "bfloat16":
        stages = ns * bk * (tr + 8 + tc + 8) * 2
    else:
        stages = ns * bk * (tr + 4 + tc + 4) * 4 + 3 * bk * (tr + 8 + tc + 8) * 2
    return (4 * q * ds + 4 * npair * ds + 4 * _r4(i_s + j_s)
            + max(stages, 4 * npair * (q + 4), 4 * q * ds))


def _bwd_grid(tiles: int, sms: int) -> tuple[int, int]:
    """(blocks, cluster): as few blocks as keep the waves of tiles (never
    more than the SMs), in whole clusters of up to ``BWD_CLUSTER``."""
    nb = min(tiles, sms)
    nb = -(-tiles // -(-tiles // nb))
    c = min(BWD_CLUSTER, 1 << (nb.bit_length() - 1))
    nb = -(-nb // c) * c
    if nb > sms:
        nb = sms // c * c
    return nb, c


def _bwd_layout(shapes: Sequence[tuple], s: int, clusters: int) -> tuple[int, tuple]:
    """Bytes and float offsets of the scratch, as ``bwd_workspace`` in the
    CUDA source reckons it.  Chain vectors and cotangents are kept once per
    distinct prefix (suffix) of digit pairs: phi_k, mu_k hold
    ``prod(i_t j_t, t < k) * d_k`` floats, rho_k, lam_k
    ``prod(i_t j_t, t >= k) * d_k``; each region is rounded to 16 bytes."""
    g = [c[1] * c[2] for c in shapes]
    n = len(shapes)
    off = 0
    regions = []
    for sizes in ([math.prod(g[:k]) * shapes[k][0] for k in range(1, s + 1)],) * 2 + (
            [math.prod(g[k:]) * shapes[k][0] for k in range(s, n)],) * 2:
        offs = []
        for size in sizes:
            offs.append(off)
            off += _r4(size)
        regions.append(tuple(offs))
    q = math.prod(g[s:])
    part = off
    off += clusters * q * shapes[s][0]
    return 4 * off, (*regions, part)


def _job_macs(shapes: Sequence[tuple], s: int) -> int:
    """Multiply-adds of the chain and pullback jobs: each core once per
    distinct prefix (suffix) of digit pairs, three times (chain, its
    gradient, the cotangent one core further)."""
    g = [c[1] * c[2] for c in shapes]
    size = [math.prod(c) for c in shapes]
    return 3 * (sum(math.prod(g[:k]) * size[k] for k in range(s))
                + sum(math.prod(g[k + 1:]) * size[k] for k in range(s, len(shapes))))


@functools.lru_cache(maxsize=4096)
def _bwd_plan(shapes: tuple, dtype: str = "bfloat16", sms: int = MMA_SMS) -> BwdPlan | None:
    """The cores-backward kernel's launch for these core shapes in this
    dtype on a card of ``sms`` SMs, or None when it cannot take them.

    Needs a bond whose R (``d_s * Is * Js``, d_s and Is * Js multiples of 4)
    fits ``BWD_RMAX`` and a tile of ``BWD_TILES`` that holds whole (is, js)
    groups, an even number of pairs, within ``SMEM_LIMIT``.  Among those,
    scratch below an f32 dW first, then the least time, reckoned at 2048
    rows in CUDA-core multiply-adds an SM: the slower of the blocks' work
    (waves of tiles, each x^T dy on the tensor cores at ~16 times the CUDA
    cores' rate, the pullback's 2 d_s a dW value, R and the dR share) and
    the L2 traffic of re-reading x and dy for every tile (~5.5 multiply-adds
    a byte an SM), plus the jobs' multiply-adds spread over the SMs."""
    n = len(shapes)
    if dtype not in BWD_STAGES or not 2 <= n <= MAXN or shapes[0][0] != 1 or shapes[-1][3] != 1:
        return None
    if any(a[3] != b[0] for a, b in zip(shapes, shapes[1:])):
        return None
    i_dim = math.prod(c[1] for c in shapes)
    j_dim = math.prod(c[2] for c in shapes)
    best = None
    for s in range(1, n):
        ds = shapes[s][0]
        i_s = math.prod(c[1] for c in shapes[s:])
        j_s = math.prod(c[2] for c in shapes[s:])
        q = i_s * j_s
        if ds % 4 or q % 4 or ds * q > BWD_RMAX:
            continue
        for tr, tc in BWD_TILES:
            if tr % i_s or tc % j_s or (tr // i_s) * (tc // j_s) % 2:
                continue
            smem = _bwd_smem_bytes(ds, i_s, j_s, tr, tc, dtype)
            if smem > SMEM_LIMIT:
                continue
            pi, pj = tr // i_s, tc // j_s
            tiles = -(-(i_dim // i_s) // pi) * -(-(j_dim // j_s) // pj)
            blocks, cluster = _bwd_grid(tiles, sms)
            ws, (phi, mu, rho, lam, part) = _bwd_layout(shapes, s, blocks // cluster)
            work = -(-tiles // blocks) * (tr * tc * (128 + 2 * ds) + 4 * q * ds)
            traffic = tiles * 4096 * (tr + tc) * 5.5 / sms
            cost = max(work, traffic) + _job_macs(shapes, s) / sms
            key = (ws >= 4 * i_dim * j_dim, cost, tiles)
            if best is None or key < best[0]:
                best = (key, BwdPlan(s, tr, tc, pi * pj, tiles, cluster, blocks, smem, ws,
                                     phi, mu, rho, lam, part))
    return None if best is None else best[1]


def _bwd_group(workspace: int, n_stack: int) -> int:
    """Experts a launch set of the cores backward takes over a stack of
    ``n_stack`` matrices whose scratch is ``workspace`` bytes each: all of
    them when their scratch fits ``BWD_STACK_SCRATCH``, else the fewest
    groups of equal size (the last smaller) that fit, at least one expert
    a group."""
    most = max(1, min(n_stack, BWD_STACK_SCRATCH // max(workspace, 1)))
    return -(-n_stack // -(-n_stack // most))


def _bwd_maps(shapes: Sequence[tuple], s: int) -> list[torch.Tensor]:
    """The index maps of the tile pass: a prefix pair (ip, jp) is row
    ``pmi[ip] + pmj[jp]`` of L and dL, a suffix pair (is, js) row
    ``qmi[is] + qmj[js]`` of R and dR.  Rows are numbered by the digit pairs
    (i_k, j_k) of the cores in order, the first most significant, so the
    pairs that share a prefix (suffix) of digits are contiguous."""
    def group(cores):
        g = [c[1] * c[2] for c in cores]
        ni = math.prod(c[1] for c in cores)
        nj = math.prod(c[2] for c in cores)
        mi = torch.zeros(ni, dtype=torch.int64)
        mj = torch.zeros(nj, dtype=torch.int64)
        ii, jj = torch.arange(ni), torch.arange(nj)
        for k, c in enumerate(cores):
            place = math.prod(g[k + 1:])
            mi += ii // math.prod(d[1] for d in cores[k + 1:]) % c[1] * c[2] * place
            mj += jj // math.prod(d[2] for d in cores[k + 1:]) % c[2] * place
        return [mi, mj]

    return group(shapes[:s]) + group(shapes[s:])


def _bwd_jobs(shapes: Sequence[tuple], plan: BwdPlan, needs: Sequence[bool]
              ) -> tuple[list[tuple], int, list[tuple], int]:
    """The job runner's work, ``(chain jobs, chain steps, epilogue jobs,
    epilogue steps)``.  A job is the batched product
    ``out[z, m, n] = sum_{k1, k2} A[z, m, k1, k2] * B[z, k1, k2, n]``, summed
    in order of ``k = k1 * K2 + k2`` in f32, each operand an offset and
    strides into a core (read as f32), the workspace or the value 1; jobs of
    one step are independent, each step waits for the last.

    Chains: phi_{k+1} = phi_k . C_k per distinct prefix (k = 0..s-1) and
    rho_k = C_k . rho_{k+1} per distinct suffix (k = n-1..s).  Epilogue,
    after the tile pass has written mu_s = dL and the dR partials: for the
    prefix, dC_k = phi_k^T . mu_{k+1} and mu_k = mu_{k+1} . C_k^T
    (k = s-1..0); for the suffix, lam_s = the partials summed in cluster
    order, then dC_k = sum over the suffix of lam_k x rho_{k+1} and
    lam_{k+1} = lam_k . C_k (k = s..n-1).  An epilogue sum longer than
    ``BWD_KSLICE`` is split into slices, one job each, whose partials are
    summed in slice order at the next step (so a long sum is spread over
    blocks, not walked by one).  A core not in ``needs`` gets no gradient
    job, and no cotangent is carried past the last core that needs it."""
    n, s = len(shapes), plan.split
    d = [c[0] for c in shapes] + [1]
    g = [c[1] * c[2] for c in shapes]
    pre = [math.prod(g[:k]) for k in range(n + 1)]     # D_k: distinct prefixes
    suf = [math.prod(g[k:]) for k in range(n + 1)]     # N_k: distinct suffixes
    phi = {k + 1: o for k, o in enumerate(plan.phi)}
    mu = {k + 1: o for k, o in enumerate(plan.mu)}
    rho = {s + k: o for k, o in enumerate(plan.rho)}
    lam = {s + k: o for k, o in enumerate(plan.lam)}
    q = suf[s]

    def job(step, m, nn, k1, k2=1, z=1, a=(BWD_ONES, 0, 0, 0, 0, 0),
            b=(BWD_ONES, 0, 0, 0, 0, 0), c=(BWD_WS, 0, 0, 0, 0)):
        return (step, m, nn, k1, k2, z, *a, *b, *c)

    ones = (BWD_ONES, 0, 0, 0, 0, 0)

    def phi_at(k, sm, s1):
        """phi_k ([P][d_k]) as an A operand with strides ``sm`` along m and
        ``s1`` along k1.  phi_0 = [1]; phi_1 is core 0 itself
        ([i0 j0][d_1]) unless it is L (s = 1)."""
        if k == 0:
            return ones
        return (0 if k == 1 and s > 1 else BWD_WS, 0 if k == 1 and s > 1 else phi[k],
                0, sm, s1, 0)

    def rho_at(k, srow, scol, b=False):
        """rho_k, row S' and column, as an A (b False: strides sm, s1) or B
        (b True: s1, sn) operand.  rho_{n-1} is core n-1 itself
        (rho_{n-1}[S'][b] = C_{n-1}[b, S', 0]) unless it is R (s = n - 1)."""
        if k == n - 1 and n - 1 > s:
            srow, scol, src, off = 1, g[n - 1], n - 1, 0
        else:
            src, off = BWD_WS, rho[k]
        return (src, off, 0, srow, 0, scol) if b else (src, off, 0, srow, scol, 0)

    chain = []
    for k in range(1 if s > 1 else 0, s):
        kk = g[k] * d[k + 1]
        chain.append(job(k - (s > 1), pre[k], kk, d[k], a=phi_at(k, d[k], 1),
                         b=(k, 0, 0, kk, 0, 1), c=(BWD_WS, phi[k + 1], 0, kk, 1)))
    top = n - 2 if n - 1 > s else n - 1
    for k in range(top, s - 1, -1):
        nk = suf[k + 1]
        a = ones if k == n - 1 else rho_at(k + 1, d[k + 1], 1)
        chain.append(job(top - k, nk, d[k], d[k + 1], z=g[k], a=a,
                         b=(k, 0, d[k + 1], 1, 0, g[k] * d[k + 1]),
                         c=(BWD_WS, rho[k], nk * d[k], d[k], 1)))
    csteps = max(s - (s > 1), top - s + 1)

    epi = []

    def add(step, j, scratch, room):
        """j at ``step``; a long sum as slices of at most ``BWD_KSLICE`` of
        its k that write partials to ``scratch`` (a region dead by then, of
        ``room`` floats), summed in slice order at the next step.  Returns
        the floats of scratch it took and whether it was split."""
        f = dict(zip(JOB_FIELDS, j))
        per = max(1, BWD_KSLICE // f["K2"], -(-f["K1"] // 8))    # at most 8 slices
        parts = -(-f["K1"] // per)
        out = f["M"] * f["N"]
        if (parts == 1 or f["Z"] != 1 or f["c_sm"] != f["N"] * f["c_sn"]
                or parts * out > room or len(epi) + parts + 1 > BWD_MAXJOBS - 2 * n):
            epi.append(j)
            return 0, False
        for i in range(parts):
            lo = i * per
            g = dict(f, K1=min(per, f["K1"] - lo), a_off=f["a_off"] + lo * f["a_s1"],
                     b_off=f["b_off"] + lo * f["b_s1"], c_dst=BWD_WS, c_off=scratch + i * out,
                     c_sz=0, c_sm=f["N"], c_sn=1)
            epi.append(tuple(g[k] for k in JOB_FIELDS))
        epi.append(job(step + 1, out, 1, parts, a=(BWD_WS, scratch, 0, 1, out, 0),
                       c=(f["c_dst"], f["c_off"], 0, f["c_sn"], 0)))
        return parts * out, True

    # prefix: slices' partials in L's region (phi_s, dead after the tile pass)
    t, room = 0, pre[s] * d[s]
    for k in range(s - 1, -1 if s == 1 else 0, -1):
        kk = g[k] * d[k + 1]
        used, split = 0, False
        if needs[k]:
            used, split = add(t, job(t, d[k], kk, pre[k], a=phi_at(k, 1, d[k]),
                                     b=(BWD_WS, mu[k + 1], 0, kk, 0, 1), c=(k, 0, 0, kk, 1)),
                              phi[s], room)
        if k >= 1 and any(needs[:k]):
            # dC_0 = mu_1 (phi_0 = [1]): the job writes core 0's gradient
            c = (0, 0, 0, d[k], 1) if k == 1 else (BWD_WS, mu[k], 0, d[k], 1)
            u, sp = add(t, job(t, pre[k], d[k], kk, a=(BWD_WS, mu[k + 1], 0, kk, 1, 0),
                               b=(k, 0, 0, 1, 0, kk), c=c), phi[s] + used, room - used)
            split |= sp
        t += 2 if split else 1
    steps = t
    # suffix: lam_s = the partials in cluster order; slices in R's region
    if any(needs[s:]):
        e = q * d[s]
        epi.append(job(0, e, 1, plan.blocks // plan.cluster,
                       a=(BWD_WS, plan.part, 0, 1, e, 0), c=(BWD_WS, lam[s], 0, 1, 0)))
    t = 1
    for k in range(s, n):
        nk, split = suf[k + 1], False
        if needs[k]:
            b = ones if k == n - 1 else rho_at(k + 1, d[k + 1], 1, b=True)
            epi.append(job(t, d[k], d[k + 1], nk, z=g[k],
                           a=(BWD_WS, lam[k], nk * d[k], 1, d[k], 0), b=b,
                           c=(k, 0, d[k + 1], g[k] * d[k + 1], 1)))
        if k + 1 < n and any(needs[k + 1:]):
            _, split = add(t, job(t, nk, d[k + 1], g[k], k2=d[k],
                                  a=(BWD_WS, lam[k], 0, d[k], nk * d[k], 1),
                                  b=(k, 0, 0, d[k + 1], g[k] * d[k + 1], 1),
                                  c=(BWD_WS, lam[k + 1], 0, d[k + 1], 1)), rho[s], q * d[s])
        t += 2 if split else 1
        steps = max(steps, t)
    return chain, csteps, epi, steps


def _bwd_cores_one(cores: list, x: torch.Tensor, dy: torch.Tensor, needs: list) -> list:
    """One matrix's plain cores backward (``mpo_linear_bwd_cores_plain``)."""
    i_dim = math.prod(c.shape[1] for c in cores)
    j_dim = math.prod(c.shape[2] for c in cores)
    acc = _acc_dtype(x.dtype)
    dw = x.reshape(-1, i_dim).to(acc).T @ dy.reshape(-1, j_dim).to(acc)
    with torch.enable_grad():
        cs = [c.detach().to(acc).requires_grad_(k) for c, k in zip(cores, needs)]
        w = mpo.reconstruct(cs)
        want = [c for c in cs if c.requires_grad]
        got = iter(torch.autograd.grad(w, want, dw) if want else ())
    return [next(got).to(c.dtype) if k else None for c, k in zip(cores, needs)]


def mpo_linear_bwd_cores_plain(cores: Sequence[torch.Tensor], x: torch.Tensor,
                               dy: torch.Tensor, needs: Sequence[bool] | None = None
                               ) -> list[torch.Tensor | None]:
    """The plain version: ``dW = x^T dy`` in f32, pulled back through
    ``mpo.reconstruct`` in f32 by autograd, one rounding to the cores' dtype
    — the arithmetic the kernel does, in another order.  ``needs[k]`` False
    gives None for core k.  Over a stack (5-D cores, x ``(E, ..., I)``, dy
    ``(E, ..., J)``) each matrix's gradients come from its own rows, one
    matrix at a time (no ``(E, I, J)`` dW at once)."""
    mpo_linear_bwd_cores_plain.calls += 1
    cores = list(cores)
    needs = [True] * len(cores) if needs is None else list(needs)
    if cores[0].dim() == 4:
        return _bwd_cores_one(cores, x, dy, needs)
    n = cores[0].shape[0]
    per = [_bwd_cores_one([c[e] for c in cores], x[e], dy[e], needs) for e in range(n)]
    return [torch.stack([p[k] for p in per]) if k_need else None
            for k, k_need in enumerate(needs)]


mpo_linear_bwd_cores_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("mpo_linear_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mpo_linear_bwd_workspace.argtypes = [ctypes.POINTER(i32), i32, i32, i32, i32]
    lib.mpo_linear_bwd_workspace.restype = ctypes.c_long
    lib.mpo_linear_bwd_smem.argtypes = [ctypes.POINTER(i32), i32, i32, i32, i32, i32]
    lib.mpo_linear_bwd_smem.restype = ctypes.c_long
    lib.mpo_linear_bwd_cores.argtypes = [
        ctypes.POINTER(ptr), ctypes.POINTER(ptr), ctypes.POINTER(i32), i32,
        ctypes.POINTER(i32), ptr, ptr, ptr, i32, i32, i32, i32, ptr, ptr]
    lib.mpo_linear_bwd_cores.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _bwd_meta(shapes: tuple, dtype: str, needs: tuple, sms: int, device: torch.device):
    """``(plan, meta, args)`` of a call: the job table and index maps as one
    int32 array on the card, and the host arguments of the C entry point."""
    plan = _bwd_plan(shapes, dtype, sms)
    chain, csteps, epi, esteps = _bwd_jobs(shapes, plan, needs)
    assert max(len(chain), len(epi)) <= BWD_MAXJOBS
    meta = torch.cat([torch.tensor([v for j in chain + epi for v in j], dtype=torch.int64),
                      *_bwd_maps(shapes, plan.split)]).to(torch.int32).to(device)
    s = plan.split
    args = (s, plan.tr, plan.tc, plan.cluster, plan.blocks, sms, len(chain), csteps, len(epi),
            esteps, int(any(needs[:s])), int(any(needs[s:])), plan.phi[-1], plan.rho[0],
            plan.mu[-1], plan.part)
    return plan, meta, (ctypes.c_int * len(args))(*args)


def mpo_linear_bwd_cores(cores: Sequence[torch.Tensor], x: torch.Tensor,
                         dy: torch.Tensor, needs: Sequence[bool] | None = None
                         ) -> list[torch.Tensor | None]:
    """Per-core gradients of ``sum(dy * (x @ W(cores)))`` without dW or W in
    device memory; ``needs[k]`` False skips core k (None in its place, and
    no work for it).  A stack of E matrices of one shape — 5-D cores ``(E,
    d0, i, j, d1)``, x ``(E, ..., I)``, dy ``(E, ..., J)`` — gives each
    matrix's gradients from its own rows, planned as the one matrix.

    CUDA tensors launch the kernel, ``csrc/mpo_linear_bwd.cu``: three
    launches (``BWD_KERNELS``) a set, one set a call, and over a stack one
    set for every group of ``_bwd_group`` experts (all of them where their
    scratch fits ``BWD_STACK_SCRATCH``); a call counts once in
    ``mpo_linear_bwd_cores.launches``, a call over a stack of more than one
    matrix also in ``.stacked_launches``; ``.workspace_bytes`` is the last
    call's scratch and ``.launch_sets`` its launch sets.  CPU tensors take
    ``mpo_linear_bwd_cores_plain``.  Raises on anything the kernel does not
    take."""
    _build.refuse_dtensor("mpo_linear_bwd_cores", x, dy, *cores)
    cores = list(cores)
    needs = [True] * len(cores) if needs is None else [bool(k) for k in needs]
    if x.device.type == "cpu":
        return mpo_linear_bwd_cores_plain(cores, x, dy, needs)
    if x.device.type != "cuda":
        raise ValueError(f"mpo_linear_bwd_cores: unsupported device {x.device}")
    rank = cores[0].dim()
    if rank not in (4, 5) or any(c.dim() != rank for c in cores):
        raise ValueError(f"mpo_linear_bwd_cores: cores must be 4-D, or 5-D for a stack, got "
                         f"{[tuple(c.shape) for c in cores]}")
    n_stack = cores[0].shape[0] if rank == 5 else 1
    if rank == 5 and (any(c.shape[0] != n_stack for c in cores) or x.dim() < 2 or dy.dim() < 2
                      or x.shape[0] != n_stack or dy.shape[0] != n_stack):
        raise ValueError(f"mpo_linear_bwd_cores: a stack of {n_stack} matrices needs every "
                         f"core's, x's and dy's leading dim {n_stack}, got x {tuple(x.shape)}, "
                         f"dy {tuple(dy.shape)}")
    shapes = tuple(tuple(c.shape[-4:]) for c in cores)
    for t in (*cores, dy):
        if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError("mpo_linear_bwd_cores: cores and dy must be contiguous, "
                             f"on x's device and in x's dtype ({x.dtype}, {x.device})")
    if x.dtype not in DTYPES or not x.is_contiguous():
        raise ValueError(f"mpo_linear_bwd_cores: x must be contiguous float32/bfloat16, "
                         f"got {x.dtype}")
    i_dim = math.prod(s[1] for s in shapes)
    j_dim = math.prod(s[2] for s in shapes)
    m = x.numel() // max(n_stack * i_dim, 1)
    if x.shape[-1] != i_dim or dy.shape[-1] != j_dim or dy.numel() != n_stack * m * j_dim:
        raise ValueError(f"mpo_linear_bwd_cores: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} do not fit W of {i_dim} x {j_dim}")
    dtype = "float32" if x.dtype == torch.float32 else "bfloat16"
    sms = _sm_count(x.device.index)
    plan = _bwd_plan(shapes, dtype, sms)
    if plan is None:
        raise ValueError(f"mpo_linear_bwd_cores: the kernel does not take {dtype} core "
                         f"shapes {shapes}")
    outs = [torch.empty_like(c) if k else None for c, k in zip(cores, needs)]
    if m == 0 or not any(needs):
        return [o.zero_() if o is not None else None for o in outs]
    if x.data_ptr() % 16:
        x = x.clone()                  # cp.async copies x and dy in 16-byte chunks
    if dy.data_ptr() % 16:
        dy = dy.clone()
    plan, meta, args = _bwd_meta(shapes, dtype, tuple(needs), sms, x.device)
    group = _bwd_group(plan.workspace, n_stack)
    ws = torch.empty(group * plan.workspace // 4, dtype=torch.float32, device=x.device)
    ptrs = (ctypes.c_void_p * len(cores))(*[c.data_ptr() for c in cores])
    optrs = (ctypes.c_void_p * len(cores))(*[o.data_ptr() if o is not None else None
                                             for o in outs])
    lib = _bwd_lib()
    _build.launch("mpo_linear_bwd_cores", x, lambda stream: lib.mpo_linear_bwd_cores(
        ptrs, optrs, _dims(shapes), len(cores), args, meta.data_ptr(), x.data_ptr(),
        dy.data_ptr(), m, n_stack, group, DTYPES[x.dtype], ws.data_ptr(), stream))
    mpo_linear_bwd_cores.launches += 1
    mpo_linear_bwd_cores.stacked_launches += n_stack > 1
    mpo_linear_bwd_cores.workspace_bytes = group * plan.workspace
    mpo_linear_bwd_cores.launch_sets = -(-n_stack // group)
    return outs


mpo_linear_bwd_cores.launches = 0
mpo_linear_bwd_cores.stacked_launches = 0
mpo_linear_bwd_cores.workspace_bytes = 0
mpo_linear_bwd_cores.launch_sets = 0


class MPOLinearFn(torch.autograd.Function):
    """``x @ W(cores)`` through the kernels, differentiable — the reference's
    ``_mpo_linear`` custom VJP.  Saves only ``(cores, x)``; ``dL/dx`` is the
    forward kernel over the i/j-swapped cores (made contiguous), cast to x's
    dtype, and ``dL/dcores`` the cores-backward kernel.  ``block_m`` is the
    forward's row tile (0: its plan's own); ``dL/dx`` runs at it too where
    the swapped cores' kernel takes that tile at dy's rows, else at its own
    plan's.  Only the gradients autograd asks for are computed::

        y = MPOLinearFn.apply(x, block_m, *cores)
    """

    @staticmethod
    def forward(ctx, x, block_m, *cores):
        _build.refuse_dtensor("MPOLinearFn", x, *cores)
        ctx.save_for_backward(*cores, x)
        ctx.block_m = block_m
        return mpo_linear(cores, x, block_m)

    @staticmethod
    def backward(ctx, dy):
        *cores, x = ctx.saved_tensors
        dy = dy.contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            swapped = [c.contiguous() for c in mpo.transpose_cores(cores)]
            bm = ctx.block_m
            if bm and dy.device.type == "cuda":
                rows = math.prod(dy.shape[1 if cores[0].dim() == 5 else 0:-1])
                dtype = "float32" if dy.dtype == torch.float32 else "bfloat16"
                if forward_plan([c.shape[-4:] for c in swapped], rows, dtype, bm) is None:
                    bm = 0
            dx = mpo_linear(swapped, dy, bm).to(x.dtype)
        needs = list(ctx.needs_input_grad[2:])
        dcores = mpo_linear_bwd_cores(cores, x, dy, needs) if any(needs) else [None] * len(cores)
        return (dx, None, *dcores)
