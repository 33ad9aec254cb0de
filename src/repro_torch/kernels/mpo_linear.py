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
* ``mpo_linear_cuda_core`` (``csrc/mpo_linear.cu``) is the same forward
  for the float32 core shapes the tensor-core plan refuses (the narrow
  matrices of the smoke configs, qwen3-14b's ``lm_head``), on the CUDA
  cores: each block keeps R in shared memory, rebuilds W sub-blocks and
  loops over all of I with f32 accumulators.  ``forward_kernel`` names the
  kernel a call takes, from the core shapes and dtype alone; ``mpo_linear``
  is the entry point of both.
* ``mpo_linear_bwd_cores`` (``csrc/mpo_linear_bwd.cu``) replaces
  ``_bwd_cores_call`` / ``_bwd_cores_kernel``: tiles of ``dW = x^T dy`` are
  formed in shared memory only and pulled back through the same split into
  per-core gradients, without atomics, so two runs give the same bits.

``MPOLinearFn`` is the autograd function around them (the reference's
``_mpo_linear`` custom VJP): ``dL/dx`` is the forward over i/j-swapped
cores, ``dL/dcores`` the backward kernel.  Each wrapper launches its kernel
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

# must match csrc/mpo_linear.cu
MAXN = 8
KC, PC = 16, 32
TILES = {0: (64, 64), 1: (16, 16)}   # tile id -> (BM, BN) output tile
SMALL_M = 16                         # at most this many rows: 16 x 16 tiles
SMEM_LIMIT = 227 * 1024              # dynamic shared memory one block may use
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _smem_bytes(shapes: Sequence[tuple], s: int, njp: int, tile: int = 0) -> int:
    bm, bn = TILES[tile]
    ds = shapes[s][0]
    i_s = math.prod(c[1] for c in shapes[s:])
    j_s = math.prod(c[2] for c in shapes[s:])
    dmax = max(c[0] for c in shapes)
    return 4 * (ds * i_s * j_s + njp * ds + 2 * max(PC, njp) * dmax + KC * bn
                + bm * (KC + 1))


@functools.lru_cache(maxsize=None)
def _launch_plan(shapes: tuple, tile: int = 0) -> tuple[int, int] | None:
    """``(split, njp)`` for these core shapes and output tile, or None when
    the kernel cannot take them.  Among the bonds whose suffix contraction
    fits in shared memory, picks the one with the least per-block work: the
    prefix vectors, the W sub-block rebuild and the suffix contraction."""
    n = len(shapes)
    if not 2 <= n <= MAXN or shapes[0][0] != 1 or shapes[-1][3] != 1:
        return None
    if any(a[3] != b[0] for a, b in zip(shapes, shapes[1:])):
        return None
    bn = TILES[tile][1]
    i_dim = math.prod(c[1] for c in shapes)
    best = None
    for s in range(1, n):
        ds = shapes[s][0]
        i_s = math.prod(c[1] for c in shapes[s:])
        j_s = math.prod(c[2] for c in shapes[s:])
        j_p = math.prod(c[2] for c in shapes[:s])
        njp = min(j_p, (bn - 1) // j_s + 2)
        if _smem_bytes(shapes, s, njp, tile) > SMEM_LIMIT:
            continue
        prefix = sum(c[0] * c[3] for c in shapes[:s])
        suffix = sum(c[0] * c[3] for c in shapes[s:])
        cost = (i_dim // i_s) * njp * prefix + i_dim * bn * ds + i_s * j_s * suffix
        if best is None or cost < best[0]:
            best = (cost, s, njp)
    return None if best is None else best[1:]


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


@dataclasses.dataclass(frozen=True)
class MmaPlan:
    split: int          # bond s of the L / R split
    bm: int             # rows an output tile: 16, 64 or 128
    tc: int             # jp columns a rebuild patch: 4 or 2
    splits: int         # S, blocks that share one tile's stages of I
    smem: int           # dynamic shared memory of the main kernel, bytes
    workspace: int      # bytes of scratch: R, P, then the [S, M, J] f32 partials


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
def _mma_plan(shapes: tuple, m: int, dtype: str = "bfloat16") -> MmaPlan | None:
    """The tensor-core kernel's launch for these core shapes at ``m`` rows
    in this dtype, or None when it cannot take the shapes.  Rows: 16 up to
    16, 64 up to ``SPLIT_M``, else 128 (float32: 64 where 128 does not fit
    shared memory)."""
    s = _mma_split(shapes, dtype)
    if s is None:
        return None
    g = _mma_geometry(shapes, s, dtype)
    bm = 16 if m <= 16 else 64 if m <= SPLIT_M else 128
    if _mma_smem_bytes(g, bm, dtype) > SMEM_LIMIT:
        bm = 64
    i_dim = math.prod(c[1] for c in shapes)
    j_dim = math.prod(c[2] for c in shapes)
    splits = _mma_splits(i_dim, j_dim, m, bm)
    ws = 4 * (g["ds"] * g["i_s"] * g["j_s"] + g["p"] + (splits * m * j_dim if splits > 1 else 0))
    return MmaPlan(s, bm, g["tc"], splits, _mma_smem_bytes(g, bm, dtype), ws)


# the dW tile edge (and KC, the rows staged per step) must match
# csrc/mpo_linear_bwd.cu; the two limits keep a block's shared memory to R,
# its dR partial and an L slice of at most these many floats
BWD_TILE = 64
BWD_RMAX = 16384                     # suffix contraction R (d_s * Is * Js)
BWD_LMAX = 4096                      # the tile's L slice (pairs * d_s)


def _bwd_smem_bytes(shapes: Sequence[tuple], s: int, pi: int, pj: int) -> int:
    """Shared memory of one block of the backward's tile pass (``tile_smem``
    in the CUDA source): R and the block's dR partial, the dW tile, the
    staged x and dy rows, and the tile's L slice."""
    rsz = shapes[s][0] * math.prod(c[1] for c in shapes[s:]) * math.prod(
        c[2] for c in shapes[s:])
    return 4 * (2 * rsz + BWD_TILE * (BWD_TILE + 1) + 2 * KC * BWD_TILE
                + pi * pj * shapes[s][0])


@functools.lru_cache(maxsize=None)
def _bwd_plan(shapes: tuple) -> tuple[int, int, int] | None:
    """``(split, PI, PJ)`` of the cores-backward kernel, or None when it
    cannot take these core shapes.  A dW tile holds PI x PJ whole (ip, jp)
    sub-tiles of Is x Js (at most 64 x 64); the split needs R and the
    block's dR partial in shared memory.  Among the splits that fit, picks
    the least work: the dW tiles (padding counted), the pullback through the
    split, and the prefix and suffix chains."""
    n = len(shapes)
    if not 2 <= n <= MAXN or shapes[0][0] != 1 or shapes[-1][3] != 1:
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
        i_p, j_p = i_dim // i_s, j_dim // j_s
        if i_s > BWD_TILE or j_s > BWD_TILE or ds * i_s * j_s > BWD_RMAX:
            continue
        pi, pj = min(BWD_TILE // i_s, i_p), min(BWD_TILE // j_s, j_p)
        while pi * pj * ds > BWD_LMAX and pj > 1:
            pj //= 2
        while pi * pj * ds > BWD_LMAX and pi > 1:
            pi //= 2
        if pi * pj * ds > BWD_LMAX or _bwd_smem_bytes(shapes, s, pi, pj) > SMEM_LIMIT:
            continue
        tiles = -(-i_p // pi) * -(-j_p // pj)
        chains = (i_p * j_p * sum(c[0] * c[3] for c in shapes[:s])
                  + i_s * j_s * sum(c[0] * c[3] for c in shapes[s:]))
        cost = 256 * tiles * BWD_TILE ** 2 + 2 * ds * i_dim * j_dim + 4 * chains
        if best is None or cost < best[0]:
            best = (cost, s, pi, pj)
    return None if best is None else best[1:]


def forward_kernel(shapes: Sequence[tuple], dtype: str) -> str | None:
    """The forward kernel ``mpo_linear`` launches for these core shapes on
    the card, from the shapes and dtype alone (never after a failure):
    ``"mma"`` (``csrc/mpo_linear_mma.cu``) wherever its plan takes them;
    for float32 shapes it refuses but ``_launch_plan`` takes,
    ``"cuda_core"`` (``csrc/mpo_linear.cu``); else None."""
    return _route(tuple(tuple(int(d) for d in s) for s in shapes), dtype)


@functools.lru_cache(maxsize=None)
def _route(shapes: tuple, dtype: str) -> str | None:
    if dtype not in ("float32", "bfloat16"):
        return None
    if _mma_split(shapes, dtype) is not None:
        return "mma"
    if dtype == "float32" and _launch_plan(shapes) is not None:
        return "cuda_core"
    return None


def kernel_eligible(shapes: Sequence[tuple], *, dtype: str = "float32",
                    train: bool = False) -> bool:
    """Can the Hopper kernels run these core shapes in this activation dtype?

    bfloat16 runs ``csrc/mpo_linear_mma.cu``, whose bond must give whole
    stage and tile groups (``_mma_split``).  float32 admits what
    ``csrc/mpo_linear.cu`` takes: 2..8 cores and a bond whose suffix
    contraction fits one block's shared memory (``_launch_plan``; the 64 x 64
    tile needs the most, so it decides for both tiles).  Of those, the
    shapes the tensor-core plan takes in float32 run ``mpo_linear_mma.cu``
    and the rest ``mpo_linear.cu`` (``forward_kernel``): at the repository's
    configs that rest is six of smoke bert-base's seven matrices, the seven
    narrow matrices of smoke qwen3-14b and smoke mamba2-130m's ``out_proj``
    (W of 64 x 64 to 128 x 64: every bond's R and P exceed an eighth of it,
    or its is group is not whole 4-row patches), and full-width qwen3-14b's
    ``lm_head`` (no bond's js group divides the 128-column tile).
    ``train`` also needs the forward over the i/j-swapped cores (``dL/dx``)
    and the cores-backward kernel (``_bwd_plan``)."""
    if dtype not in ("float32", "bfloat16"):
        return False
    shapes = tuple(tuple(int(d) for d in s) for s in shapes)
    fits = ((lambda sh: _launch_plan(sh) is not None) if dtype == "float32"
            else (lambda sh: _mma_split(sh) is not None))
    if not fits(shapes):
        return False
    if not train:
        return True
    swapped = tuple((d0, j, i, d1) for d0, i, j, d1 in shapes)
    return fits(swapped) and _bwd_plan(shapes) is not None


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' working type: float32, as the kernels sum (float64
    inputs, which no kernel takes, keep float64 for ``gradcheck``)."""
    return torch.promote_types(dtype, torch.float32)


def mpo_linear_plain(cores: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The plain version: W rebuilt in f32, f32 product, one rounding to
    x's dtype — the arithmetic the kernel does, in another order."""
    mpo_linear_plain.calls += 1
    acc = _acc_dtype(x.dtype)
    w = mpo.reconstruct([c.to(acc) for c in cores])
    lead = x.shape[:-1]
    return (x.reshape(-1, w.shape[0]).to(acc) @ w).to(x.dtype).reshape(*lead, w.shape[1])


mpo_linear_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mpo_linear")
    lib.mpo_linear_fwd.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    lib.mpo_linear_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _mma_lib() -> ctypes.CDLL:
    lib = _build.load("mpo_linear_mma")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mpo_linear_mma_smem.argtypes = [ctypes.POINTER(i32), i32, i32, i32, i32]
    lib.mpo_linear_mma_smem.restype = ctypes.c_long
    lib.mpo_linear_mma_workspace.argtypes = [ctypes.POINTER(i32), i32, i32, i32, i32, i32]
    lib.mpo_linear_mma_workspace.restype = ctypes.c_long
    lib.mpo_linear_mma_fwd.argtypes = [
        ctypes.POINTER(ptr), ctypes.POINTER(i32), i32, i32, i32, i32, i32, ptr, ptr, i32,
        ptr, i32, ptr]
    lib.mpo_linear_mma_fwd.restype = i32
    return lib


def mpo_linear(cores: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``y[..., J] = x[..., I] @ W(cores)`` without W in device memory.

    CPU tensors take ``mpo_linear_plain``.  CUDA tensors launch the kernel
    ``forward_kernel`` names: ``csrc/mpo_linear_mma.cu`` (``mpo_linear_mma``)
    in both dtypes, or for the float32 shapes its plan refuses
    ``csrc/mpo_linear.cu`` (``mpo_linear_cuda_core``); each wrapper counts
    its launches.  Raises on anything the kernels do not take: other devices
    or dtypes, mixed dtypes, non-contiguous inputs, shapes neither takes."""
    cores = list(cores)
    if x.device.type == "cpu":
        return mpo_linear_plain(cores, x)
    shapes = tuple(tuple(c.shape) for c in cores)
    if any(len(s) != 4 for s in shapes):
        raise ValueError(f"mpo_linear: cores must be 4-D, got {shapes}")
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
    m = math.prod(x.shape[:-1])
    dtype = "float32" if x.dtype == torch.float32 else "bfloat16"
    route = _route(shapes, dtype)
    if route is None:
        raise ValueError(f"mpo_linear: no {dtype} kernel takes core shapes {shapes}")
    fn = mpo_linear_mma if route == "mma" else mpo_linear_cuda_core
    return fn(cores, shapes, j_dim, m, x)


@functools.lru_cache(maxsize=None)
def _dims(shapes: tuple):
    """The core shapes as the C entry points take them: 4 ints a core."""
    return (ctypes.c_int * (4 * len(shapes)))(*[d for s in shapes for d in s])


def mpo_linear_cuda_core(cores: list, shapes: tuple, j_dim: int, m: int,
                         x: torch.Tensor) -> torch.Tensor:
    """Launches ``csrc/mpo_linear.cu`` on the float32 inputs ``mpo_linear``
    checked (``mpo_linear_cuda_core.launches`` counts its launches)."""
    tile = 1 if m <= SMALL_M else 0
    plan = _launch_plan(shapes, tile)
    if plan is None or x.dtype != torch.float32:
        raise ValueError(f"mpo_linear: the CUDA-core kernel does not take {x.dtype} "
                         f"core shapes {shapes}")
    split, njp = plan
    if m > 65535 * TILES[tile][0]:
        raise ValueError(f"mpo_linear: {m} rows exceed the launch grid")
    y = torch.empty(*x.shape[:-1], j_dim, dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    ptrs = (ctypes.c_void_p * len(cores))(*[c.data_ptr() for c in cores])
    _build.launch("mpo_linear_fwd", x, lambda stream: _lib().mpo_linear_fwd(
        ptrs, _dims(shapes), len(cores), split, njp, tile, x.data_ptr(), y.data_ptr(), m,
        stream))
    mpo_linear_cuda_core.launches += 1
    return y


mpo_linear_cuda_core.launches = 0


def mpo_linear_mma(cores: list, shapes: tuple, j_dim: int, m: int,
                   x: torch.Tensor) -> torch.Tensor:
    """Launches ``csrc/mpo_linear_mma.cu`` on the inputs ``mpo_linear``
    checked, in their dtype (``mpo_linear_mma.launches`` counts its launches;
    ``mpo_linear_mma.workspace_bytes`` is the last call's scratch: R, P and
    the split-I partials, never W)."""
    dtype = "float32" if x.dtype == torch.float32 else "bfloat16"
    plan = _mma_plan(shapes, m, dtype)
    if plan is None:
        raise ValueError(f"mpo_linear: the tensor-core kernel does not take {dtype} "
                         f"core shapes {shapes}")
    if m > 65535 * plan.bm:
        raise ValueError(f"mpo_linear: {m} rows exceed the launch grid")
    y = torch.empty(*x.shape[:-1], j_dim, dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    if x.data_ptr() % 16:
        x = x.clone()                  # cp.async copies x in 16-byte chunks
    ws = torch.empty(plan.workspace // 4, dtype=torch.float32, device=x.device)
    ptrs = (ctypes.c_void_p * len(cores))(*[c.data_ptr() for c in cores])
    _build.launch("mpo_linear_mma_fwd", x, lambda stream: _mma_lib().mpo_linear_mma_fwd(
        ptrs, _dims(shapes), len(cores), plan.split, plan.bm, plan.tc, plan.splits,
        x.data_ptr(), y.data_ptr(), m, ws.data_ptr(), DTYPES[x.dtype], stream))
    mpo_linear_mma.launches += 1
    mpo_linear_mma.workspace_bytes = plan.workspace
    return y


mpo_linear_mma.launches = 0
mpo_linear_mma.workspace_bytes = 0


# --------------------------------------------------------------------------
# cores backward
# --------------------------------------------------------------------------


def mpo_linear_bwd_cores_plain(cores: Sequence[torch.Tensor], x: torch.Tensor,
                               dy: torch.Tensor, needs: Sequence[bool] | None = None
                               ) -> list[torch.Tensor | None]:
    """The plain version: ``dW = x^T dy`` in f32, pulled back through
    ``mpo.reconstruct`` in f32 by autograd, one rounding to the cores' dtype
    — the arithmetic the kernel does, in another order.  ``needs[k]`` False
    gives None for core k."""
    mpo_linear_bwd_cores_plain.calls += 1
    cores = list(cores)
    needs = [True] * len(cores) if needs is None else list(needs)
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


mpo_linear_bwd_cores_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("mpo_linear_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mpo_linear_bwd_workspace.argtypes = [ctypes.POINTER(i32), i32, i32, i32]
    lib.mpo_linear_bwd_workspace.restype = ctypes.c_long
    lib.mpo_linear_bwd_cores.argtypes = [
        ctypes.POINTER(ptr), ctypes.POINTER(ptr), ctypes.POINTER(i32), i32, i32, i32, i32,
        i32, ptr, ptr, i32, i32, ptr, ptr]
    lib.mpo_linear_bwd_cores.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bwd_blocks(shapes: Sequence[tuple], sms: int) -> int:
    """Blocks of the kernel's tile pass: as few as keep every SM's share of
    the dW tiles the same, never more than the SM count, so the per-block
    dR partials stay bounded."""
    split, pi, pj = _bwd_plan(tuple(tuple(s) for s in shapes))
    i_s = math.prod(c[1] for c in shapes[split:])
    j_s = math.prod(c[2] for c in shapes[split:])
    i_p = math.prod(c[1] for c in shapes) // i_s
    j_p = math.prod(c[2] for c in shapes) // j_s
    tiles = -(-i_p // pi) * -(-j_p // pj)
    return -(-tiles // -(-tiles // sms))


def bwd_workspace(shapes: Sequence[tuple], nblocks: int) -> int:
    """Floats of core-space scratch one call of the kernel takes (the
    chain vectors, L and dL, the block partials of dR), as the CUDA source
    lays it out; freed after the call."""
    shapes = tuple(tuple(s) for s in shapes)
    dims = (ctypes.c_int * (4 * len(shapes)))(*[d for s in shapes for d in s])
    return _bwd_lib().mpo_linear_bwd_workspace(dims, len(shapes), _bwd_plan(shapes)[0],
                                               nblocks)


def mpo_linear_bwd_cores(cores: Sequence[torch.Tensor], x: torch.Tensor,
                         dy: torch.Tensor, needs: Sequence[bool] | None = None
                         ) -> list[torch.Tensor | None]:
    """Per-core gradients of ``sum(dy * (x @ W(cores)))`` without dW or W in
    device memory; ``needs[k]`` False skips core k (None in its place).

    CUDA tensors launch the kernel (``mpo_linear_bwd_cores.launches`` counts
    the launches); CPU tensors take ``mpo_linear_bwd_cores_plain``.  Raises
    on anything the kernel does not take."""
    cores = list(cores)
    needs = [True] * len(cores) if needs is None else list(needs)
    if x.device.type == "cpu":
        return mpo_linear_bwd_cores_plain(cores, x, dy, needs)
    if x.device.type != "cuda":
        raise ValueError(f"mpo_linear_bwd_cores: unsupported device {x.device}")
    shapes = tuple(tuple(c.shape) for c in cores)
    if any(len(s) != 4 for s in shapes):
        raise ValueError(f"mpo_linear_bwd_cores: cores must be 4-D, got {shapes}")
    for t in (*cores, dy):
        if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError("mpo_linear_bwd_cores: cores and dy must be contiguous, "
                             f"on x's device and in x's dtype ({x.dtype}, {x.device})")
    if x.dtype not in DTYPES or not x.is_contiguous():
        raise ValueError(f"mpo_linear_bwd_cores: x must be contiguous float32/bfloat16, "
                         f"got {x.dtype}")
    i_dim = math.prod(s[1] for s in shapes)
    j_dim = math.prod(s[2] for s in shapes)
    m = x.numel() // max(i_dim, 1)
    if x.shape[-1] != i_dim or dy.shape[-1] != j_dim or dy.numel() != m * j_dim:
        raise ValueError(f"mpo_linear_bwd_cores: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} do not fit W of {i_dim} x {j_dim}")
    plan = _bwd_plan(shapes)
    if plan is None:
        raise ValueError(f"mpo_linear_bwd_cores: the kernel does not take core shapes {shapes}")
    split, pi, pj = plan
    nblocks = bwd_blocks(shapes, _sm_count(x.device.index or 0))
    lib = _bwd_lib()
    dims = (ctypes.c_int * (4 * len(cores)))(*[d for s in shapes for d in s])
    ws = torch.empty(bwd_workspace(shapes, nblocks), dtype=torch.float32, device=x.device)
    outs = [torch.empty_like(c) if k else None for c, k in zip(cores, needs)]
    ptrs = (ctypes.c_void_p * len(cores))(*[c.data_ptr() for c in cores])
    optrs = (ctypes.c_void_p * len(cores))(*[o.data_ptr() if o is not None else None
                                             for o in outs])
    _build.launch("mpo_linear_bwd_cores", x, lambda stream: lib.mpo_linear_bwd_cores(
        ptrs, optrs, dims, len(cores), split, pi, pj, nblocks, x.data_ptr(), dy.data_ptr(),
        m, DTYPES[x.dtype], ws.data_ptr(), stream))
    mpo_linear_bwd_cores.launches += 1
    return outs


mpo_linear_bwd_cores.launches = 0


class MPOLinearFn(torch.autograd.Function):
    """``x @ W(cores)`` through the kernels, differentiable — the reference's
    ``_mpo_linear`` custom VJP.  Saves only ``(cores, x)``; ``dL/dx`` is the
    forward kernel over the i/j-swapped cores (made contiguous), cast to x's
    dtype, and ``dL/dcores`` the cores-backward kernel.  Only the gradients
    autograd asks for are computed::

        y = MPOLinearFn.apply(x, *cores)
    """

    @staticmethod
    def forward(ctx, x, *cores):
        ctx.save_for_backward(*cores, x)
        return mpo_linear(cores, x)

    @staticmethod
    def backward(ctx, dy):
        *cores, x = ctx.saved_tensors
        dy = dy.contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            swapped = [c.contiguous() for c in mpo.transpose_cores(cores)]
            dx = mpo_linear(swapped, dy).to(x.dtype)
        needs = list(ctx.needs_input_grad[1:])
        dcores = mpo_linear_bwd_cores(cores, x, dy, needs) if any(needs) else [None] * len(cores)
        return (dx, *dcores)
