"""Chunked Mamba2 SSD scan (state-space duality), the SSM family's prefill,
and its backward, the SSM family's fine-tuning.

The forward replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py:
ssd_scan`` / ``_kernel``.  The CUDA source is ``repro_torch/csrc/ssd_scan.cu``;
its header says what bounds it on an H100 and how the design answers.  Where
the TPU kernel walks the chunks in order and carries the (N, P) state in
VMEM, the card runs the chunks in parallel in three launches a call
(``SSD_KERNELS``): the chunk states on the tensor cores, a short elementwise
pass that carries the state across the chunks (its last value is the final
state prefill keeps), and the chunk outputs on the tensor cores, C·Bᵀ formed
once a block for a group of heads.  ``_ssd_plan`` gives the head group, the
grids, each launch's shared memory and the scratch (the f32 chunk states and
decays).

The backward (``csrc/ssd_scan_bwd.cu``, four launches a call,
``SSD_BWD_KERNELS``) replaces no TPU kernel: the reference differentiates
its plain ``ssd_chunked`` with ``jax.grad``, and on the card the plain
version may not stand in for a kernel.  It reads the carried states and
chunk decays the forward leaves in its scratch; ``SSDScanFn`` hands them
over through ``save_for_backward``.  ``_ssd_bwd_plan`` gives its launches.

``ssd_scan`` and ``ssd_scan_bwd`` launch the kernels for CUDA tensors and
call ``ssd_scan_plain`` (the port of the reference's plain ``ssd_chunked``)
and ``ssd_scan_bwd_plain`` (its gradients, written out as the same chunked
formulas the kernel runs) only for CPU tensors.  There is no fallback from a
kernel to its plain version: a failure raises.  ``ssd_scan_ref`` is the
sequential oracle of the tests.
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
SSD_BWD_KERNELS = 4      # backward: d(prev), reverse state pass, chunk gradients, sums
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


@dataclasses.dataclass(frozen=True)
class SsdBwdPlan:
    group: int          # heads a block of launches 1 and 3
    grids: tuple        # blocks of launches 1, 2, 3 and 4
    smem: tuple         # dynamic shared memory of launches 1-4, bytes
    workspace: int      # scratch bytes (``_ssd_bwd_workspace``)


def _ssd_bwd_smem(q: int, n: int, p: int, group: int, dtype: str) -> tuple:
    """``ssd_scan_bwd_smem`` in the CUDA source.  Tiles hold values, not
    bf16 terms (the terms are split as the fragments load), at a row pitch
    of 8 more than their padded width: x's dtype for inputs (x, B, C, dy),
    f32 for f32-valued operands.  Launch 1: dt and dac of the group's
    heads, C, and exp(dac) o dy.  Launch 3 (either role): dt and dac, the
    tile kept throughout (B, or C), the tile the C·Bᵀ blocks are formed from
    (C, or B) whose space a head's three tiles reuse (dy, x o dt and the
    carried state, or its gradient), the warps' blocks of C·Bᵀ on one side
    of the diagonal (16 x 16 f32 each), and 16 floats of block sums."""
    isz = 2 if dtype == "bfloat16" else 4
    qp, np_, pp = _rup16(q), _rup16(n), _rup16(p)
    nq = qp // 16
    floats = 4 * 2 * group * qp
    cn, tp, sp = isz * qp * (np_ + 8), qp * (pp + 8), np_ * (pp + 8)
    head = isz * tp + 4 * tp + 4 * sp
    roles = floats + cn + max(cn, head) + 4 * 256 * nq * (nq + 1) // 2 + 4 * 16
    return (floats + cn + 4 * tp, 0, roles, 0)


def _ssd_bwd_workspace(b: int, s: int, h: int, p: int, n: int, q: int, group: int) -> int:
    """``ssd_scan_bwd_workspace``: f32 d(state) (B, NC, H, N, P), the two
    roles' d(dac) (B, NC, H, q) each, the last position's extra (B, NC, H),
    <dy, x> a position (B, S, H), and the partial dB and dC of each head
    group (B, NC, H / group, q, N) each."""
    nc = s // q
    units = b * nc * h
    return 4 * (units * (n * p + 2 * q + 1) + b * s * h + 2 * b * nc * (h // group) * q * n)


@functools.lru_cache(maxsize=1024)
def _ssd_bwd_plan(b: int, s: int, h: int, p: int, n: int, q: int, dtype: str = "bfloat16",
                  sms: int = SSD_SMS) -> SsdBwdPlan:
    """The backward's launch at these shapes.  Launch 3 runs two blocks a
    (batch, chunk, group of G heads), one for each side of the diagonal,
    one block an SM (its shared memory); its C·Bᵀ blocks are formed once a
    block and cost about half a head's products.  G (a divisor of H, at
    most ``SSD_GMAX``, its shared memory within one block's) is the one
    whose waves over the card times a block's work, ``g + 1/2`` heads, is
    least; ties go to the larger G."""
    nc = s // q

    def cost(g):
        return math.ceil(2 * b * nc * (h // g) / sms) * (g + 0.5), -g

    fits = [g for g in range(1, min(h, SSD_GMAX) + 1)
            if h % g == 0 and max(_ssd_bwd_smem(q, n, p, g, dtype)) <= SMEM_LIMIT]
    group = min(fits, key=cost)
    blocks = b * nc * (h // group)
    vec = 4 if (n * p) % 4 == 0 else 1
    return SsdBwdPlan(group, (blocks, b * h * -(-(n * p) // (SSD_PASS * vec)), 2 * blocks,
                              h + -(-(2 * b * s * n) // 256)),
                      _ssd_bwd_smem(q, n, p, group, dtype),
                      _ssd_bwd_workspace(b, s, h, p, n, q, group))


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


def ssd_scan_bwd_plain(x, dt, a_log, b, c, d_skip, dy, d_final, chunk: int):
    """The plain version of the backward: the gradients of ``ssd_scan_plain``
    written out as the chunked formulas the kernel runs (not autograd of the
    forward), in f32.  ``dy`` (B, S, H, P) is y's cotangent, ``d_final``
    (B, H, N, P) the final state's or None (zero).  Per (batch, chunk,
    head), with dac the chunk's cumulative sum of da = -exp(a_log) dt, xw =
    x dt, L_ij = exp(dac_i - dac_j) (j <= i), M = (C Bᵀ) o L, s_j =
    exp(dac_last - dac_j), e_c = exp(dac_last) and prev_c the state carried
    into the chunk:

    1. dprev_c = Cᵀ diag(exp(dac)) dy;
    2. from G = d_final, over the chunks in reverse: dS_c = G, then
       G = G e_c + dprev_c;
    3. dxw = Mᵀ dy + s o (B dS_c); dC and dB from dCB = Σ_heads (dy xwᵀ) o L,
       plus the carried state's terms; d(dac) from T = (dy xwᵀ) o M, the
       carried state's output, the chunk state and e_c's <dS_c, prev_c>;
       dda its reverse cumulative sum within the chunk;
    4. dx = dxw dt + D dy, ddt = <dxw, x> - exp(a_log) dda, da_log =
       Σ dda da, dD = Σ <dy, x>.

    Returns ``(dx, ddt, da_log, db, dc, dd_skip)``: dx, db and dc in x's
    dtype, the rest f32."""
    ssd_scan_bwd_plain.calls += 1
    bs, s, h, p = x.shape
    n = b.shape[-1]
    q = chunk_len(s, chunk)
    nc = s // q
    a = torch.exp(a_log.float())
    da = -a * dt.float()                                          # (B, S, H)
    xw = (x.float() * dt.float()[..., None]).reshape(bs, nc, q, h, p)
    dyc = dy.float().reshape(bs, nc, q, h, p)
    bc = b.float().reshape(bs, nc, q, n)
    cc = c.float().reshape(bs, nc, q, n)
    dac = torch.cumsum(da.reshape(bs, nc, q, h), dim=2)           # (B, NC, q, H)
    lmat = torch.exp(segsum(da.reshape(bs, nc, q, h).transpose(2, 3)))   # (B, NC, H, q, q)
    mmat = torch.einsum("bcij,bchij->bchij", torch.einsum("bcin,bcjn->bcij", cc, bc), lmat)
    sdec = torch.exp(dac[:, :, -1:, :] - dac)                     # (B, NC, q, H)
    edec = torch.exp(dac)
    chunk_decay = torch.exp(dac[:, :, -1, :])                     # (B, NC, H)

    # the forward's carried states
    states = torch.einsum("bcqn,bcqh,bcqhp->bchnp", bc, sdec, xw)
    state = torch.zeros_like(states[:, 0])
    prev = []
    for ci in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev = torch.stack(prev, dim=1)                               # (B, NC, H, N, P)

    # 1-2. the carried state's gradient, over the chunks in reverse
    dprev = torch.einsum("bcqn,bcqh,bcqhp->bchnp", cc, edec, dyc)
    g = torch.zeros_like(state) if d_final is None else d_final.float()
    ds = [None] * nc
    for ci in reversed(range(nc)):
        ds[ci] = g
        g = g * chunk_decay[:, ci, :, None, None] + dprev[:, ci]
    ds = torch.stack(ds, dim=1)                                   # (B, NC, H, N, P)

    # 3. within each chunk
    dm = torch.einsum("bcihp,bcjhp->bchij", dyc, xw)              # dy xwᵀ
    v = torch.einsum("bcjn,bchnp->bcjhp", bc, ds)                 # B dS_c
    dxw = torch.einsum("bchij,bcihp->bcjhp", mmat, dyc) + sdec[..., None] * v
    dcb = torch.einsum("bchij,bchij->bcij", dm, lmat)
    r = torch.einsum("bcihp,bchnp->bcihn", dyc, prev)             # dy prev_cᵀ
    u = torch.einsum("bcjhp,bchnp->bcjhn", xw, ds)                # xw dS_cᵀ
    dc = (torch.einsum("bcij,bcjn->bcin", dcb, bc)
          + torch.einsum("bcih,bcihn->bcin", edec, r))
    db = (torch.einsum("bcij,bcin->bcjn", dcb, cc)
          + torch.einsum("bcjh,bcjhn->bcjn", sdec, u))
    t = dm * mmat
    bu = torch.einsum("bcjn,bcjhn->bcjh", bc, u)                  # <B_j dS_c, xw_j>
    ddac = (t.sum(-1) - t.sum(-2)).permute(0, 1, 3, 2)            # (B, NC, q, H)
    ddac = ddac + edec * torch.einsum("bcin,bcihn->bcih", cc, r) - sdec * bu
    last = (sdec * bu).sum(2) + chunk_decay * (ds * prev).sum((-2, -1))
    ddac[:, :, -1] += last
    dda = torch.flip(torch.cumsum(torch.flip(ddac, (2,)), dim=2), (2,)).reshape(bs, s, h)

    # 4. per position, then over batch and positions
    dxw = dxw.reshape(bs, s, h, p)
    dx = dxw * dt.float()[..., None] + d_skip.float()[None, None, :, None] * dy.float()
    ddt = (dxw * x.float()).sum(-1) - a * dda
    da_log = (dda * da).sum((0, 1))
    dd_skip = (dy.float() * x.float()).sum((0, 1, 3))
    return (dx.to(x.dtype), ddt, da_log, db.reshape(bs, s, n).to(x.dtype),
            dc.reshape(bs, s, n).to(x.dtype), dd_skip)


ssd_scan_bwd_plain.calls = 0


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


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan_bwd")
    call = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.ssd_scan_bwd.argtypes = call
    lib.ssd_scan_bwd.restype = ctypes.c_int
    lib.ssd_scan_bwd_launch.argtypes = [ctypes.c_int] + call
    lib.ssd_scan_bwd_launch.restype = ctypes.c_int
    lib.ssd_scan_bwd_smem.argtypes = [ctypes.c_int] * 6
    lib.ssd_scan_bwd_smem.restype = ctypes.c_longlong
    lib.ssd_scan_bwd_workspace.argtypes = [ctypes.c_int] * 7
    lib.ssd_scan_bwd_workspace.restype = ctypes.c_longlong
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


def _run_bwd(inputs, dy, d_final, fws, grads, ws, q, group, stream, launch=0):
    """One whole call of the backward (``launch`` 0), or for timing launch
    1-4 alone on whatever its scratch holds.  ``inputs`` are the forward's
    six, ``fws`` its scratch, ``grads`` the six outputs.  Returns the CUDA
    error, 0 when every launch was accepted."""
    x, b = inputs[0], inputs[3]
    bs, s, h, p = x.shape
    ptrs = [t.data_ptr() for t in inputs] + [dy.data_ptr(), 0 if d_final is None else
                                             d_final.data_ptr(), fws.data_ptr()]
    args = (*ptrs, *[g.data_ptr() for g in grads], ws.data_ptr(), bs, s, h, p, b.shape[-1], q,
            group, DTYPES[x.dtype], stream)
    if launch:
        return _bwd_lib().ssd_scan_bwd_launch(launch, *args)
    return _bwd_lib().ssd_scan_bwd(*args)


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
    # grids: (batch, chunk, head group) blocks, twice in the backward, and 8
    # blocks a (batch, head) at most
    if q > QMAX or n > NMAX or p > PMAX or bs * max(2 * (s // q), 8) * h >= 2 ** 31:
        raise ValueError(f"ssd_scan: the kernel does not take chunk {q}, N={n}, P={p} "
                         f"(at most {QMAX}, {NMAX}, {PMAX})")


def _dtype_name(t: torch.Tensor) -> str:
    return "float32" if t.dtype == torch.float32 else "bfloat16"


def _forward(x, dt, a_log, b, c, d_skip, chunk: int):
    """``(y, final_state, scratch)``: the kernel for CUDA tensors, whose
    scratch then holds the carried states and chunk decays the backward
    reads; the plain version for CPU tensors (no scratch, None)."""
    if x.device.type == "cpu":
        return (*ssd_scan_plain(x, dt, a_log, b, c, d_skip, chunk), None)
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
        return y, state, torch.empty(0, device=x.device)
    plan = _ssd_plan(bs, s, h, p, n, q, _dtype_name(x), _sm_count(x.device.index))
    ws = torch.empty(plan.workspace // 4, dtype=torch.float32, device=x.device)
    _build.launch("ssd_scan", x, lambda stream: _run(
        x, dt, a_log, b, c, d_skip, y, state, ws, q, plan.group, stream))
    ssd_scan.launches += 1
    return y, state, ws


def ssd_scan(x, dt, a_log, b, c, d_skip, chunk: int):
    """Chunked SSD scan: ``(y, final_state)`` for x (B, S, H, P) in f32 or
    bf16, dt (B, S, H) f32, a_log and d_skip (H,) f32, b and c (B, S, N) in
    x's dtype; chunk length ``min(chunk, S)``, which must divide S.

    CUDA tensors launch the kernel: ``SSD_KERNELS`` launches a call, counted
    once in ``ssd_scan.launches``.  CPU tensors take ``ssd_scan_plain``.
    Inputs that need a gradient go through ``SSDScanFn``, whose backward is
    ``ssd_scan_bwd``.  Raises on anything the kernel does not take: other
    devices or dtypes, strided inputs, a chunk above 128, N above 128, P
    above 64."""
    _build.refuse_dtensor("ssd_scan", x, dt, a_log, b, c, d_skip)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a_log, b, c, d_skip)):
        return SSDScanFn.apply(x, dt, a_log, b, c, d_skip, chunk)
    return _forward(x, dt, a_log, b, c, d_skip, chunk)[:2]


ssd_scan.launches = 0


def ssd_scan_bwd(x, dt, a_log, b, c, d_skip, dy, d_final, fws, chunk: int):
    """Gradients of ``ssd_scan``: ``(dx, ddt, da_log, db, dc, dd_skip)``
    from y's cotangent ``dy`` (x's dtype and shape) and the final state's
    ``d_final`` ((B, H, N, P) f32, or None for zero); dx, db and dc in x's
    dtype, ddt, da_log and dd_skip f32.  ``fws`` is the scratch the forward
    kernel left for these inputs (``_forward``): the carried states and
    chunk decays.

    CUDA tensors launch the kernel, ``SSD_BWD_KERNELS`` launches a call,
    counted once in ``ssd_scan_bwd.launches``; CPU tensors take
    ``ssd_scan_bwd_plain`` (``fws`` unused).  Raises on what the kernel
    does not take (``ssd_scan``'s limits) and on a scratch of another size."""
    _build.refuse_dtensor("ssd_scan_bwd", x, dt, a_log, b, c, d_skip, dy)
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, dt, a_log, b, c, d_skip, dy, d_final, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd: unsupported device {x.device}")
    bs, s, h, p = x.shape
    q = chunk_len(s, chunk)
    inputs = (x, dt, a_log, b, c, d_skip)
    _check(*inputs, q)
    n = b.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"ssd_scan_bwd: dy must be a contiguous {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}, got {dy.dtype} {tuple(dy.shape)}")
    if d_final is not None and (tuple(d_final.shape) != (bs, h, n, p)
                                or d_final.dtype != torch.float32
                                or d_final.device != x.device or not d_final.is_contiguous()):
        raise ValueError(f"ssd_scan_bwd: d_final must be a contiguous float32 "
                         f"{(bs, h, n, p)} on {x.device}")
    dtype = _dtype_name(x)
    fwd_plan = _ssd_plan(bs, s, h, p, n, q, dtype, _sm_count(x.device.index))
    if fws is None or fws.dtype != torch.float32 or fws.numel() * 4 != fwd_plan.workspace \
            or fws.device != x.device:
        raise ValueError("ssd_scan_bwd: fws must be the forward kernel's scratch for "
                         "these inputs")
    grads = (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(a_log),
             torch.empty_like(b), torch.empty_like(c), torch.empty_like(d_skip))
    if bs * h == 0:
        return tuple(g.zero_() for g in grads)
    plan = _ssd_bwd_plan(bs, s, h, p, n, q, dtype, _sm_count(x.device.index))
    ws = torch.empty(plan.workspace // 4, dtype=torch.float32, device=x.device)
    _build.launch("ssd_scan_bwd", x, lambda stream: _run_bwd(
        inputs, dy, d_final, fws, grads, ws, q, plan.group, stream))
    ssd_scan_bwd.launches += 1
    return grads


ssd_scan_bwd.launches = 0


class SSDScanFn(torch.autograd.Function):
    """``ssd_scan`` through the kernels, differentiable: the forward keeps
    its scratch (the carried states and chunk decays) with the inputs in
    ``save_for_backward``, so that a checkpoint's saved-tensor hooks free
    it and its recompute makes it again; the backward is ``ssd_scan_bwd``.
    A final state that no loss reads gives a zero ``d_final`` (None)::

        y, final_state = SSDScanFn.apply(x, dt, a_log, b, c, d_skip, chunk)
    """

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, d_skip, chunk):
        _build.refuse_dtensor("SSDScanFn", x, dt, a_log, b, c, d_skip)
        y, state, fws = _forward(x, dt, a_log, b, c, d_skip, chunk)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a_log, b, c, d_skip, fws)
        return y, state

    @staticmethod
    def backward(ctx, dy, d_final):
        x, dt, a_log, b, c, d_skip, fws = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if d_final is not None:
            d_final = d_final.contiguous()
        grads = ssd_scan_bwd(x, dt, a_log, b, c, d_skip, dy, d_final, fws, ctx.chunk)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)
