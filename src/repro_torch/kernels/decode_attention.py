"""Flash decode attention over a paged KV cache.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py:_flash_jit``
(``_flash_kernel`` with its page-clamped index maps).  The CUDA source is
``repro_torch/csrc/decode_attention.cu``; its header says what bounds it on
an H100 and how the design answers: one block per (slot, kv head) walks only
its own slot's pages, so the clamp trick is not needed, and the G query heads
of a group share each page load.

``flash_decode_attention`` launches the kernel for CUDA tensors and calls
``flash_decode_attention_plain`` only for CPU tensors.  There is no fallback
from the kernel to the gather path: a failure raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

MASK_VALUE = -2.3819763e38          # the fill attention_scores uses
_TINY = 1e-30                       # zero-valid-keys guard (idle slots)
THREADS, MAXR = 128, 16             # must match csrc/decode_attention.cu
SMEM_LIMIT = 227 * 1024
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
                                 *, softcap: float | None = None):
    """The plain version: gathered pages and one f32 softmax over the keys
    of each slot's first ``ceil(length / page_size)`` pages — the result the
    kernel's online softmax gives, summed in another order."""
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
    l = w.sum(-1, keepdim=True).clamp(min=_TINY)
    return (torch.einsum("bkgs,bskd->bkgd", w, v) / l).to(q.dtype)


flash_decode_attention_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    lib.flash_decode_attention.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_decode_attention.restype = ctypes.c_int
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
    smem = 4 * (g * dh + ps * (dh + 1) + ps * dh + g * ps + 3 * g)
    if g * dh > THREADS * MAXR or smem > SMEM_LIMIT or kv > 65535:
        raise ValueError(f"flash_decode_attention: the kernel does not take "
                         f"G={g}, Dh={dh}, page_size={ps}, KV={kv}")


def flash_decode_attention(q, k_pages, v_pages, page_table, lengths, bias,
                           *, softcap: float | None = None):
    """Single-token flash decoding over paged KV.

    q:          (B, KV, G, Dh)   — grouped query heads (H = KV * G)
    k_pages:    (P, ps, KV, Dh)  — physical page pool (v_pages alike)
    page_table: (B, MP) int32    — logical -> physical page, -1 = unmapped
    lengths:    (B,) int32       — valid keys per slot (<= MP * ps)
    bias:       (B, MP * ps) f32 — additive mask (0 keep / MASK_VALUE drop)

    Returns (B, KV, G, Dh) in q's dtype.  CUDA tensors launch the kernel
    (``flash_decode_attention.launches`` counts the launches); CPU tensors
    take ``flash_decode_attention_plain``."""
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k_pages, v_pages, page_table,
                                            lengths, bias, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: unsupported device {q.device}")
    _check(q, k_pages, v_pages, page_table, lengths, bias)
    b, kv, g, dh = q.shape
    p, ps = k_pages.shape[:2]
    out = torch.empty_like(q)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().flash_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), bias.data_ptr(), out.data_ptr(), b, kv, g, dh, p, ps,
        page_table.shape[1], 1.0 / math.sqrt(dh), float(softcap or 0.0),
        DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode_attention launch failed: CUDA error {rc}")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
