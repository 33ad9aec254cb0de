"""Chunked Mamba2 SSD scan (state-space duality), the SSM family's prefill.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py:ssd_scan`` /
``_kernel``.  The CUDA source is ``repro_torch/csrc/ssd_scan.cu``; its header
says what bounds it on an H100 and how the design answers: one block per
(batch, head) loops over the chunks in order and carries the (N, P) f32
state in shared memory, as the TPU kernel carries it in VMEM scratch across
its sequential chunk axis; after the last chunk the block writes it out as
the final state, which prefill keeps per layer.

``ssd_scan`` launches the kernel for CUDA tensors and calls
``ssd_scan_plain`` (the port of the reference's plain ``ssd_chunked``) only
for CPU tensors.  There is no fallback from the kernel to the plain version:
a failure raises.  ``ssd_scan_ref`` is the sequential oracle of the tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# must match csrc/ssd_scan.cu; at these caps one block's shared memory fits
QMAX, NMAX, PMAX = 128, 128, 64
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def chunk_len(s: int, chunk: int) -> int:
    """The chunk length the scan uses, ``min(chunk, s)``; the sequence must
    be a whole number of chunks, as the reference asserts."""
    q = min(chunk, s)
    if q <= 0 or s % q != 0:
        raise ValueError(f"ssd_scan: seq {s} not divisible by chunk {q}")
    return q


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums, ``out[..., i, j] = sum_{j<k<=i} x[..., k]``,
    formed as differences of one cumulative sum (as the reference forms them,
    so the rounding matches); -inf above the diagonal."""
    t = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    out = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_scan_plain(x, dt, a_log, b, c, d_skip, chunk: int):
    """The plain version: the reference's ``ssd_chunked`` — intra-chunk
    quadratic term, chunk states, the inter-chunk recurrence as a loop over
    chunks, and the off-diagonal term — in f32, one rounding of y to x's
    dtype.  Shapes: x (B, S, H, P), dt (B, S, H), a_log and d_skip (H,),
    b and c (B, S, N).  Returns ``(y (B, S, H, P) in x's dtype, final
    state (B, H, N, P) f32)``."""
    ssd_scan_plain.calls += 1
    bs, s, h, p = x.shape
    n = b.shape[-1]
    q = chunk_len(s, chunk)
    nc = s // q
    da = -torch.exp(a_log.float()) * dt.float()                  # (B, S, H) <= 0
    xw = x.float() * dt.float()[..., None]                        # dt-weighted input
    xc = xw.reshape(bs, nc, q, h, p)
    dac = da.reshape(bs, nc, q, h)
    bc = b.float().reshape(bs, nc, q, n)
    cc = c.float().reshape(bs, nc, q, n)

    # intra-chunk (quadratic within the chunk)
    lmat = torch.exp(segsum(dac.transpose(2, 3)))                 # (B, NC, H, q, q)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)              # (B, NC, q, q)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores[:, :, None] * lmat, xc)

    # chunk states
    dacum = torch.cumsum(dac, dim=2)                              # (B, NC, q, H)
    decay_to_end = torch.exp(dacum[:, :, -1:, :] - dacum)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchnp", bc, decay_to_end, xc)

    # inter-chunk recurrence over NC
    chunk_decay = torch.exp(dacum[:, :, -1, :])                   # (B, NC, H)
    state = torch.zeros_like(states[:, 0])
    prev_states = []
    for ci in range(nc):
        prev_states.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev = torch.stack(prev_states, dim=1)                        # (B, NC, H, N, P)

    # off-diagonal contribution of the carried state
    y_off = torch.einsum("bcqn,bcqh,bchnp->bcqhp", cc, torch.exp(dacum), prev)
    y = (y_diag + y_off).reshape(bs, s, h, p)
    y = y + x.float() * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), state


ssd_scan_plain.calls = 0


def ssd_decode_step(state, x_t, dt_t, a_log, b_t, c_t, d_skip):
    """One-token recurrence (plain ops; the reference has no kernel for it).
    state (B, H, N, P) f32; x_t (B, H, P); dt_t (B, H); b_t, c_t (B, N).
    Returns ``(new_state, y_t in x_t's dtype)``."""
    da = torch.exp(-torch.exp(a_log.float()) * dt_t.float())      # (B, H)
    xw = x_t.float() * dt_t[..., None]
    new_state = (state * da[..., None, None]
                 + torch.einsum("bn,bhp->bhnp", b_t.float(), xw))
    y = torch.einsum("bn,bhnp->bhp", c_t.float(), new_state)
    y = y + x_t.float() * d_skip[None, :, None]
    return new_state, y.to(x_t.dtype)


def ssd_scan_ref(x, dt, a_log, b, c, d_skip):
    """The sequential oracle: ``ssd_decode_step`` token by token from a zero
    state.  Returns ``(y (B, S, H, P) in x's dtype, final state (B, H, N, P)
    f32)``."""
    bs, s, h, p = x.shape
    state = torch.zeros((bs, h, b.shape[-1], p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        state, y = ssd_decode_step(state, x[:, t], dt[:, t], a_log, b[:, t], c[:, t], d_skip)
        ys.append(y)
    return torch.stack(ys, dim=1), state


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan_fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.ssd_scan_fwd.restype = ctypes.c_int
    return lib


def _check(x, dt, a_log, b, c, d_skip, q):
    tensors = (x, dt, a_log, b, c, d_skip)
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssd_scan: all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan: inputs must be contiguous (make the in_proj "
                         "slices contiguous first)")
    if x.dtype not in DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"ssd_scan: x, b and c must share a float32/bfloat16 dtype, "
                         f"got {x.dtype}, {b.dtype}, {c.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, a_log, d_skip)):
        raise ValueError("ssd_scan: dt, a_log and d_skip must be float32")
    bs, s, h, p = x.shape
    n = b.shape[-1]
    if (tuple(dt.shape) != (bs, s, h) or tuple(b.shape) != (bs, s, n)
            or tuple(c.shape) != (bs, s, n) or tuple(a_log.shape) != (h,)
            or tuple(d_skip.shape) != (h,)):
        raise ValueError(f"ssd_scan: inconsistent shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}, "
                         f"a_log {tuple(a_log.shape)}, d_skip {tuple(d_skip.shape)}")
    if q > QMAX or n > NMAX or p > PMAX or bs * h >= 2 ** 31:
        raise ValueError(f"ssd_scan: the kernel does not take chunk {q}, N={n}, P={p} "
                         f"(at most {QMAX}, {NMAX}, {PMAX})")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("ssd_scan: the CUDA kernel has no backward "
                                  "(ROADMAP.md, Queue 1 item 10)")


def ssd_scan(x, dt, a_log, b, c, d_skip, chunk: int):
    """Chunked SSD scan: ``(y, final_state)`` for x (B, S, H, P) in f32 or
    bf16, dt (B, S, H) f32, a_log and d_skip (H,) f32, b and c (B, S, N) in
    x's dtype; chunk length ``min(chunk, S)``, which must divide S.

    CUDA tensors launch the kernel (``ssd_scan.launches`` counts the
    launches); CPU tensors take ``ssd_scan_plain``.  Raises on anything the
    kernel does not take: other devices or dtypes, strided inputs, a chunk
    above 128, N above 128, P above 64, inputs that need a gradient."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a_log, b, c, d_skip, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, S, H, P), got {tuple(x.shape)}")
    bs, s, h, p = x.shape
    q = chunk_len(s, chunk)
    _check(x, dt, a_log, b, c, d_skip, q)
    n = b.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((bs, h, n, p), dtype=torch.float32, device=x.device)
    if bs * h == 0:
        return y, state
    _build.launch("ssd_scan", x, lambda stream: _lib().ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(), c.data_ptr(),
        d_skip.data_ptr(), y.data_ptr(), state.data_ptr(), bs, s, h, p, n, q,
        DTYPES[x.dtype], stream))
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
