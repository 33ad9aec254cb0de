"""Fused MPO-linear forward: ``y = x @ W(cores)`` with W rebuilt on chip.

Replaces the Pallas TPU kernel ``repro/kernels/mpo_linear.py:_fwd_call``
(``_fwd_kernel``, ``_tile_w``, ``_load_tile_operands``).  The CUDA source is
``repro_torch/csrc/mpo_linear.cu``; its header says what bounds it on an H100
and how the design answers.  In short: the core chain is split at a bond s,
``W[ip, is, jp, js] = sum_d L[ip, jp, d] R[d, is, js]``; each block keeps the
suffix contraction R in shared memory, rebuilds W sub-blocks from it and the
prefix vectors L, and loops over all of I itself with f32 accumulators.

``mpo_linear`` launches the kernel for CUDA tensors and calls
``mpo_linear_plain`` only for CPU tensors.  ``kernel_eligible`` is the
engine's gate: it admits what the kernel handles (the TPU's 8 x 128 tile
alignment and 16 MiB VMEM budget do not apply on Hopper).  The kernel has no
backward yet (ROADMAP.md, Queue 2 item 2), so no ``train`` plan may pick it.
"""

from __future__ import annotations

import ctypes
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


def kernel_eligible(shapes: Sequence[tuple], *, dtype: str = "float32",
                    train: bool = False) -> bool:
    """Can the Hopper kernel run these core shapes in this activation dtype?

    It needs 2..8 cores, a float32 or bfloat16 activation, and a bond whose
    suffix contraction fits one block's shared memory (``_launch_plan``; the
    64 x 64 tile needs the most, so it decides for both tiles).
    ``train`` needs a backward kernel, which comes with training."""
    if train or dtype not in ("float32", "bfloat16"):
        return False
    return _launch_plan(tuple(tuple(int(d) for d in s) for s in shapes)) is not None


def mpo_linear_plain(cores: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The plain version: W rebuilt in f32, f32 product, one rounding to
    x's dtype — the arithmetic the kernel does, in another order."""
    mpo_linear_plain.calls += 1
    w = mpo.reconstruct([c.float() for c in cores])
    lead = x.shape[:-1]
    return (x.reshape(-1, w.shape[0]).float() @ w).to(x.dtype).reshape(*lead, w.shape[1])


mpo_linear_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mpo_linear")
    lib.mpo_linear_fwd.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.mpo_linear_fwd.restype = ctypes.c_int
    return lib


def mpo_linear(cores: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``y[..., J] = x[..., I] @ W(cores)`` without W in device memory.

    CUDA tensors launch the kernel (``mpo_linear.launches`` counts the
    launches); CPU tensors take ``mpo_linear_plain``.  Raises on anything the
    kernel does not take: other devices or dtypes, mixed dtypes,
    non-contiguous inputs, shapes ``kernel_eligible`` refuses."""
    cores = list(cores)
    if x.device.type == "cpu":
        return mpo_linear_plain(cores, x)
    if x.device.type != "cuda":
        raise ValueError(f"mpo_linear: unsupported device {x.device}")
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
    lead = x.shape[:-1]
    m = math.prod(lead)
    tile = 1 if m <= SMALL_M else 0
    plan = _launch_plan(shapes, tile)
    if plan is None:
        raise ValueError(f"mpo_linear: the kernel does not take core shapes {shapes}")
    split, njp = plan
    if m > 65535 * TILES[tile][0]:
        raise ValueError(f"mpo_linear: {m} rows exceed the launch grid")
    y = torch.empty(*lead, j_dim, dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    ptrs = (ctypes.c_void_p * len(cores))(*[c.data_ptr() for c in cores])
    dims = (ctypes.c_int * (4 * len(cores)))(*[d for s in shapes for d in s])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().mpo_linear_fwd(ptrs, dims, len(cores), split, njp, tile, x.data_ptr(),
                               y.data_ptr(), m, DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"mpo_linear_fwd launch failed: CUDA error {rc}")
    mpo_linear.launches += 1
    return y


mpo_linear.launches = 0
