"""Chunked Mamba2 SSD scan (state-space duality), the SSM family's prefill.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py:ssd_scan`` /
``_kernel``.  The CUDA source is ``repro_torch/csrc/ssd_scan.cu``; its header
says what bounds it on an H100 and how the design answers.  Where the TPU
kernel walks the chunks in order and carries the (N, P) state in VMEM, the
card runs the chunks in parallel in three launches a call (``SSD_KERNELS``):
the chunk states on the tensor cores, a short elementwise pass that carries
the state across the chunks (its last value is the final state prefill
keeps), and the chunk outputs on the tensor cores, C·Bᵀ formed once a block
for a group of heads.  ``_ssd_plan`` gives the head group, the grids, each
launch's shared memory and the scratch (the f32 chunk states and decays).

``ssd_scan`` launches the kernel for CUDA tensors and calls
``ssd_scan_plain`` (the port of the reference's plain ``ssd_chunked``) only
for CPU tensors.  There is no fallback from the kernel to the plain version:
a failure raises.  ``ssd_scan_ref`` is the sequential oracle of the tests.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mpo_linear import _sm_count

# must match csrc/ssd_scan.cu; at these caps one block's shared memory fits
QMAX, NMAX, PMAX = 128, 128, 64
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SSD_KERNELS = 3          # launches a call: chunk states, state passing, chunk outputs
SSD_GMAX = 8             # most heads a block of launches 1 and 3 (a warp scan each)
SSD_PASS = 256           # state elements a block of launch 2
SSD_SMS = 132            # the H100's SMs
SMEM_LIMIT = 227 * 1024  # dynamic shared memory one block may use
SMEM_SM = 228 * 1024     # shared memory of one SM, 1 KB of it reserved a block
# blocks an SM of launch 3 its registers allow (its launch bounds);
# ``ssd_scan_resident`` in the CUDA source gives the card's count
SSD_OUT_BLOCKS = {"bfloat16": 2, "float32": 1}
# bf16 terms of an input value (x, B, C) and of an f32-valued operand (x o s,
# G', the carried state), and the term pairs taken (``ta + tb <= 2``)
SSD_TERMS = {"bfloat16": (1, 2), "float32": (3, 3)}


@dataclasses.dataclass(frozen=True)
class SsdPlan:
    group: int          # heads a block of launches 1 and 3
    grids: tuple        # blocks of launches 1, 2 and 3
    smem: tuple         # dynamic shared memory of launches 1, 2 and 3, bytes
    workspace: int      # scratch bytes: f32 chunk states (B, NC, H, N, P), decays (B, NC, H)


def _rup16(v: int) -> int:
    return -(-v // 16) * 16


def _ssd_smem(q: int, n: int, p: int, group: int, dtype: str) -> tuple:
    """``ssd_scan_smem`` in the CUDA source: dt and dac of the block's
    ``group`` heads, then bf16 tiles at a row pitch of 8 more than their
    padded width.  Launch 1: B's terms and the scaled x's terms.  Launch 3:
    C's and B's terms, whose space a head's x terms and carried-state terms
    reuse (bf16: both tiles', C's fragments then held in registers;
    float32: B's), then in bf16 the warps' C·Bᵀ blocks on or below the
    diagonal (16 x 16 f32 each)."""
    nt, wt = SSD_TERMS[dtype]
    qp, np_, pp = _rup16(q), _rup16(n), _rup16(p)
    ldn, ldp = np_ + 8, pp + 8
    floats = 4 * 2 * group * qp
    cs, head = nt * qp * ldn, nt * qp * ldp + wt * np_ * ldp
    nq = qp // 16
    if dtype == "bfloat16":
        out = floats + 2 * max(2 * cs, head) + 4 * 256 * nq * (nq + 1) // 2
    else:
        out = floats + 2 * (cs + max(cs, head))
    return (floats + 2 * (cs + wt * qp * ldp), 0, out)


def _pairs(ta: int, tb: int) -> int:
    """Products taken for operands of ``ta`` and ``tb`` bf16 terms."""
    return sum(1 for a in range(ta) for b in range(tb) if a + b <= 2)


def _ssd_resident(q: int, n: int, p: int, group: int, dtype: str) -> int:
    """Blocks of launch 3 one SM holds at once: the fewer of what its
    registers and its shared memory allow (``ssd_scan_resident``)."""
    return min(SSD_OUT_BLOCKS[dtype], SMEM_SM // (_ssd_smem(q, n, p, group, dtype)[2] + 1024))


@functools.lru_cache(maxsize=1024)
def _ssd_plan(b: int, s: int, h: int, p: int, n: int, q: int, dtype: str = "bfloat16",
              sms: int = SSD_SMS) -> SsdPlan:
    """The kernel's launch at these shapes.  The head group G (a divisor of
    H, at most ``SSD_GMAX``) shares one staging of B (launch 1) and one
    causal C·Bᵀ (launch 3).  G is the one whose estimated launch-3 time is
    least: the waves of blocks over the card's resident slots
    (``ceil(blocks / (sms * resident))``, resident from registers and
    shared memory) times a block's work, G heads' outputs plus the C·Bᵀ
    they share (``kappa`` heads' worth, counted in tensor-core products of
    16 x 16 tiles); ties go to the larger G."""
    nc = s // q
    nt, wt = SSD_TERMS[dtype]
    nq = _rup16(q) // 16
    tri = nq * (nq + 1) // 2                       # 16 x 16 tiles on or below the diagonal
    cbt = tri * _rup16(n) * _pairs(nt, nt)
    head = tri * _rup16(p) * _pairs(wt, nt) + (nq * _rup16(n) * _rup16(p) // 16
                                               * _pairs(nt, wt) if nc > 1 else 0)
    kappa = cbt / head

    def cost(g):
        slots = sms * _ssd_resident(q, n, p, g, dtype)
        return math.ceil(b * nc * (h // g) / slots) * (g + kappa), -g

    group = min((g for g in range(1, min(h, SSD_GMAX) + 1) if h % g == 0), key=cost)
    blocks = b * nc * (h // group)
    vec = 4 if (n * p) % 4 == 0 else 1
    return SsdPlan(group, (blocks, b * h * -(-(n * p) // (SSD_PASS * vec)), blocks),
                   _ssd_smem(q, n, p, group, dtype), 4 * b * nc * h * (n * p + 1))


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
    call = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.ssd_scan_fwd.argtypes = call
    lib.ssd_scan_fwd.restype = ctypes.c_int
    lib.ssd_scan_launch.argtypes = [ctypes.c_int] + call
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_resident.argtypes = [ctypes.c_int] * 5
    lib.ssd_scan_resident.restype = ctypes.c_int
    lib.ssd_scan_smem.argtypes = [ctypes.c_int] * 6
    lib.ssd_scan_smem.restype = ctypes.c_longlong
    lib.ssd_scan_workspace.argtypes = [ctypes.c_int] * 6
    lib.ssd_scan_workspace.restype = ctypes.c_longlong
    return lib


def _run(x, dt, a_log, b, c, d_skip, y, state, ws, q, group, stream, launch=0):
    """One whole call of the kernel (``launch`` 0), or for timing launch 1,
    2 or 3 alone, which gives no result of its own.  Returns the CUDA
    error, 0 when every launch was accepted."""
    bs, s, h, p = x.shape
    args = (x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(), c.data_ptr(),
            d_skip.data_ptr(), y.data_ptr(), state.data_ptr(), ws.data_ptr(), bs, s, h, p,
            b.shape[-1], q, group, DTYPES[x.dtype], stream)
    if launch:
        return _lib().ssd_scan_launch(launch, *args)
    return _lib().ssd_scan_fwd(*args)


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
    # grids: (batch, chunk, head group) blocks, and 8 blocks a (batch, head) at most
    if q > QMAX or n > NMAX or p > PMAX or bs * max(s // q, 8) * h >= 2 ** 31:
        raise ValueError(f"ssd_scan: the kernel does not take chunk {q}, N={n}, P={p} "
                         f"(at most {QMAX}, {NMAX}, {PMAX})")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("ssd_scan: the CUDA kernel has no backward "
                                  "(ROADMAP.md, Queue 1 item 10)")


def ssd_scan(x, dt, a_log, b, c, d_skip, chunk: int):
    """Chunked SSD scan: ``(y, final_state)`` for x (B, S, H, P) in f32 or
    bf16, dt (B, S, H) f32, a_log and d_skip (H,) f32, b and c (B, S, N) in
    x's dtype; chunk length ``min(chunk, S)``, which must divide S.

    CUDA tensors launch the kernel: ``SSD_KERNELS`` launches a call, counted
    once in ``ssd_scan.launches``.  CPU tensors take ``ssd_scan_plain``.
    Raises on anything the kernel does not take: other devices or dtypes,
    strided inputs, a chunk above 128, N above 128, P above 64, inputs that
    need a gradient."""
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
    dtype = "float32" if x.dtype == torch.float32 else "bfloat16"
    plan = _ssd_plan(bs, s, h, p, n, q, dtype, _sm_count(x.device.index))
    ws = torch.empty(plan.workspace // 4, dtype=torch.float32, device=x.device)
    _build.launch("ssd_scan", x, lambda stream: _run(
        x, dt, a_log, b, c, d_skip, y, state, ws, q, plan.group, stream))
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
