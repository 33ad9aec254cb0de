"""Fused, differentiable MPO-linear: ``y = x @ W(cores)`` with W rebuilt on
chip and never written to device memory, forward and backward.

Two CUDA kernels replace the Pallas TPU kernels of
``repro/kernels/mpo_linear.py``:

* ``mpo_linear`` (``csrc/mpo_linear.cu``) replaces ``_fwd_call`` /
  ``_fwd_kernel``.  The core chain is split at a bond s,
  ``W[ip, is, jp, js] = sum_d L[ip, jp, d] R[d, is, js]``; each block keeps
  the suffix contraction R in shared memory, rebuilds W sub-blocks from it
  and the prefix vectors L, and loops over all of I with f32 accumulators.
* ``mpo_linear_bwd_cores`` (``csrc/mpo_linear_bwd.cu``) replaces
  ``_bwd_cores_call`` / ``_bwd_cores_kernel``: tiles of ``dW = x^T dy`` are
  formed in shared memory only and pulled back through the same split into
  per-core gradients, without atomics, so two runs give the same bits.

``MPOLinearFn`` is the autograd function around them (the reference's
``_mpo_linear`` custom VJP): ``dL/dx`` is the forward kernel over i/j-swapped
cores, ``dL/dcores`` the backward kernel.  Each wrapper launches its kernel
for CUDA tensors and takes its plain version only for CPU tensors.
``kernel_eligible`` is the engine's gate: it admits what the kernels handle
(the TPU's 8 x 128 tile alignment and 16 MiB VMEM budget do not apply on
Hopper); with ``train=True`` both orientations and the backward must fit.
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


def kernel_eligible(shapes: Sequence[tuple], *, dtype: str = "float32",
                    train: bool = False) -> bool:
    """Can the Hopper kernels run these core shapes in this activation dtype?

    The forward needs 2..8 cores, a float32 or bfloat16 activation, and a
    bond whose suffix contraction fits one block's shared memory
    (``_launch_plan``; the 64 x 64 tile needs the most, so it decides for
    both tiles).  ``train`` also needs the forward over the i/j-swapped
    cores (``dL/dx``) and the cores-backward kernel (``_bwd_plan``)."""
    if dtype not in ("float32", "bfloat16"):
        return False
    shapes = tuple(tuple(int(d) for d in s) for s in shapes)
    if _launch_plan(shapes) is None:
        return False
    if not train:
        return True
    swapped = tuple((d0, j, i, d1) for d0, i, j, d1 in shapes)
    return _launch_plan(swapped) is not None and _bwd_plan(shapes) is not None


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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.mpo_linear_bwd_cores(ptrs, optrs, dims, len(cores), split, pi, pj, nblocks,
                                  x.data_ptr(), dy.data_ptr(), m, DTYPES[x.dtype],
                                  ws.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"mpo_linear_bwd_cores launch failed: CUDA error {rc}")
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
