"""Flash decode attention over a paged KV cache.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py:_flash_jit``
(``_flash_kernel`` with its page-clamped index maps).  The CUDA source is
``repro_torch/csrc/decode_attention.cu``; its header says what bounds it on
an H100 and how the design answers: each slot's pages are split into S
contiguous ranges (``_flash_plan``), one block per (slot, kv head, split)
walks only its own range, so the clamp trick is not needed, the G query
heads of a group share each tile of keys, and a second pass combines the
splits in split order.

``flash_decode_attention`` launches the kernel for CUDA tensors and calls
``flash_decode_attention_plain`` only for CPU tensors.  There is no fallback
from the kernel to the gather path: a failure raises (a launch error as
``_build.KernelLaunchError``; the ``flash-raise`` chaos site,
``resilience.faults.check_flash``, raises ``InjectedKernelError`` before
dispatch on either device).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.resilience import faults

MASK_VALUE = -2.3819763e38          # the fill attention_scores uses
_TINY = 1e-30                       # zero-valid-keys guard (idle slots)
THREADS, MAXR, KT = 128, 16, 32     # must match csrc/decode_attention.cu
SMEM_LIMIT = 227 * 1024
# the blocks the H100 runs at once: 132 SMs, 8 of the split kernel's
# 128-thread blocks an SM (64 registers a thread)
SMS, BLOCKS_PER_SM = 132, 8
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _flash_smem(g: int, dh: int, kt: int, esize: int) -> int:
    """``split_smem`` in the CUDA source: two buffers of K and V tiles in
    the pages' dtype, q in f32, the scores and three f32 values a head."""
    return -(-2 * 2 * kt * dh * esize // 16) * 16 + 4 * (g * dh + g * kt + 3 * g)


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    splits: int         # S: blocks that share one (slot, kv head)'s pages
    kt: int             # keys a tile
    workspace: int      # floats of the splits' (m, l, acc), 0 when S = 1


@functools.lru_cache(maxsize=1024)
def _flash_plan(b: int, kv: int, g: int, dh: int, ps: int, mp: int) -> FlashPlan:
    """The split kernel's launch.  S: as many splits as keep the B * KV * S
    blocks within two waves of the card (a wave: the blocks it runs at once,
    ``SMS * BLOCKS_PER_SM``), at most one a page of the table, so a full
    slot gives every split a page (S = 1 where B * KV already fills two
    waves).  kt: the keys of a split's pages at a full slot, at most 32, and
    halved until the float32 buffers fit shared memory (every G * Dh <= 2048
    fits at one key)."""
    splits = max(1, min(mp, 2 * SMS * BLOCKS_PER_SM // max(b * kv, 1)))
    kt = min(KT, ps * -(-mp // splits))
    while kt > 1 and _flash_smem(g, dh, kt, 4) > SMEM_LIMIT:
        kt //= 2
    return FlashPlan(splits, kt, b * kv * splits * (2 * g + g * dh) if splits > 1 else 0)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """(P, ps, KV, Dh) pages + (B, MP) table -> contiguous (B, MP*ps, KV, Dh).

    Page ids are clamped into [0, P) as the reference's gather clamps them:
    an unmapped (-1) entry reads page 0, whose positions lie past every
    slot's length, so the caller's mask removes them."""
    b, mp = page_table.shape
    _, ps, kv, dh = pages.shape
    out = pages[page_table.long().clamp(0, pages.shape[0] - 1)]   # (B, MP, ps, KV, Dh)
    return out.reshape(b, mp * ps, kv, dh)


def flash_decode_attention_plain(q, k_pages, v_pages, page_table, lengths, bias,
                                 *, softcap: float | None = None, stats: bool = False):
    """The plain version: gathered pages and one f32 softmax over the keys
    of each slot's first ``ceil(length / page_size)`` pages — the result the
    kernel's online softmax gives, summed in another order (with ``stats``
    its max score and normalizer too, as the kernel gives them)."""
    flash_decode_attention_plain.calls += 1
    b, kv, g, dh = q.shape
    ps = k_pages.shape[1]
    k = gather_pages(k_pages, page_table).float()
    v = gather_pages(v_pages, page_table).float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k) * (1.0 / math.sqrt(dh))
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = s + bias[:, None, None, :].float()
    npages = (lengths.long().clamp(min=0) + ps - 1) // ps
    valid = torch.arange(k.shape[1], device=q.device)[None, :] < (npages * ps)[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(s - m)
    l = w.sum(-1, keepdim=True)
    out = (torch.einsum("bkgs,bskd->bkgd", w, v) / l.clamp(min=_TINY)).to(q.dtype)
    return (out, m, l) if stats else out


flash_decode_attention_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    i32, f32 = ctypes.c_int, ctypes.c_float
    lib.flash_decode_attention.argtypes = (
        [ctypes.c_void_p] * 9 + [i32] * 9 + [f32, f32, i32, ctypes.c_void_p])
    lib.flash_decode_attention.restype = i32
    lib.flash_decode_attention_serial.argtypes = (
        [ctypes.c_void_p] * 7 + [i32] * 7 + [f32, f32, i32, ctypes.c_void_p])
    lib.flash_decode_attention_serial.restype = i32
    return lib


def _check(q, k_pages, v_pages, page_table, lengths, bias):
    tensors = (q, k_pages, v_pages, page_table, lengths, bias)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_decode_attention: all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode_attention: inputs must be contiguous")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("flash_decode_attention: q and pages must share a "
                         f"float32/bfloat16 dtype, got {q.dtype}, {k_pages.dtype}, "
                         f"{v_pages.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or bias.dtype != torch.float32:
        raise ValueError("flash_decode_attention: table and lengths must be int32, "
                         "bias float32")
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("flash_decode_attention: q (B, KV, G, Dh) and pages "
                         "(P, ps, KV, Dh) must be 4-D")
    b, kv, g, dh = q.shape
    p, ps, kv2, dh2 = k_pages.shape
    mp = page_table.shape[-1]
    if (kv2, dh2) != (kv, dh) or v_pages.shape != k_pages.shape \
            or page_table.shape != (b, mp) or lengths.shape != (b,) \
            or bias.shape != (b, mp * ps):
        raise ValueError("flash_decode_attention: inconsistent shapes "
                         f"q {tuple(q.shape)}, pages {tuple(k_pages.shape)}, table "
                         f"{tuple(page_table.shape)}, lengths {tuple(lengths.shape)}, "
                         f"bias {tuple(bias.shape)}")
    if g * dh > THREADS * MAXR or b * kv >= 2 ** 31 or mp > 65535:
        raise ValueError(f"flash_decode_attention: the kernel does not take "
                         f"G={g}, Dh={dh}, KV={kv}, {mp} pages a slot")


def flash_decode_attention(q, k_pages, v_pages, page_table, lengths, bias,
                           *, softcap: float | None = None, stats: bool = False):
    """Single-token flash decoding over paged KV.

    q:          (B, KV, G, Dh)   — grouped query heads (H = KV * G)
    k_pages:    (P, ps, KV, Dh)  — physical page pool (v_pages alike)
    page_table: (B, MP) int32    — logical -> physical page, -1 = unmapped
    lengths:    (B,) int32       — valid keys per slot (<= MP * ps)
    bias:       (B, MP * ps) f32 — additive mask (0 keep / MASK_VALUE drop)

    Returns (B, KV, G, Dh) in q's dtype; with ``stats`` also the f32
    softmax statistics (B, KV, G, 1) of each head, its max score ``m``
    (0 where it has no key) and normalizer ``l`` = sum exp(s - m), so that
    outputs over disjoint key sets merge (``parallel.spmd.combine_softmax``
    of ``out * l``: a pool split over the mesh).  CUDA tensors launch the kernel
    (``flash_decode_attention.launches`` counts the launches; the splits'
    workspace comes from ``torch.empty``); CPU tensors take
    ``flash_decode_attention_plain``.  An active ``flash-raise`` fault plan
    raises first, on either device."""
    _build.refuse_dtensor("flash_decode_attention", q, k_pages, v_pages, page_table,
                          lengths, bias)
    faults.check_flash()
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k_pages, v_pages, page_table,
                                            lengths, bias, softcap=softcap, stats=stats)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: unsupported device {q.device}")
    _check(q, k_pages, v_pages, page_table, lengths, bias)
    b, kv, g, dh = q.shape
    p, ps = k_pages.shape[:2]
    out = torch.empty_like(q)
    ml = torch.empty((b, kv, g, 2), dtype=torch.float32, device=q.device) if stats else None
    if b * kv == 0:
        return (out, ml[..., :1], ml[..., 1:]) if stats else out
    mp = page_table.shape[1]
    plan = _flash_plan(b, kv, g, dh, ps, mp)
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=q.device)
    _build.launch("flash_decode_attention", q, lambda stream: _lib().flash_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), bias.data_ptr(), out.data_ptr(), ws.data_ptr(),
        ml.data_ptr() if stats else None, b, kv, g, dh, p, ps, mp, plan.splits, plan.kt,
        1.0 / math.sqrt(dh), float(softcap or 0.0), DTYPES[q.dtype], stream))
    flash_decode_attention.launches += 1
    return (out, ml[..., :1], ml[..., 1:]) if stats else out


flash_decode_attention.launches = 0
