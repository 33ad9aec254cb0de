"""Matrix Product Operator (MPO) primitives — the port of ``repro.core.mpo``.

A matrix ``M[I, J]`` with ``I = prod(in_factors)``, ``J = prod(out_factors)``
is held as ``n`` 4-order cores ``T_k[d_{k-1}, i_k, j_k, d_k]`` with
``d_0 = d_n = 1``.  Row/col indices are row-major: core 0's digits are the
most significant.  The *central* core is ``k = n // 2``; the rest are
*auxiliary*.

Two execution paths for ``y = x @ MPO(W)``:

  * ``apply_mpo``   — factorized sequential contraction;
  * ``reconstruct`` — contract W once, then a dense matmul.

Algorithm 1 (``decompose``, sequential truncated SVD), the truncation
errors and entropy of Eq. 3, 4 and 6, and TT-rounding (``tt_round``, which
Algorithm 2 squeezes with) work in float32 (float64 stays float64) and take
any leading batch dims: scan-stacked ``(L, d0, i, j, d1)`` cores and
``(L, I, J)`` matrices run as one batched ``torch.linalg`` call a bond, on
the tensors' device.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence

import torch

# --------------------------------------------------------------------------
# factorization utilities
# --------------------------------------------------------------------------


def _prime_factors(n: int) -> list[int]:
    out, d = [], 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def auto_factorize(n: int, parts: int = 5, multiple: int = 1,
                   multiple_index: int = 0) -> tuple[int, ...]:
    """Split ``n`` into ``parts`` balanced integer factors (product == n).

    ``multiple`` forces ``slots[multiple_index]`` to be divisible by it (the
    leg a tensor-parallel mesh would shard)."""
    if n % multiple != 0:
        raise ValueError(f"multiple {multiple} must divide {n}")
    slots = [1] * parts
    slots[multiple_index] = multiple
    rest = n // multiple
    for p in sorted(_prime_factors(rest), reverse=True):
        # multiply into the currently-smallest slot -> balanced factors
        k = min(range(parts), key=lambda i: slots[i])
        slots[k] *= p
    if math.prod(slots) != n:
        raise AssertionError(f"factorization of {n} lost a factor: {slots}")
    return tuple(slots)


# --------------------------------------------------------------------------
# spec
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MPOSpec:
    """Static description of one MPO-factorized matrix."""

    in_factors: tuple[int, ...]
    out_factors: tuple[int, ...]
    bond_dim: int | None = None  # max bond dimension (None = exact / full rank)

    def __post_init__(self):
        if len(self.in_factors) != len(self.out_factors):
            raise ValueError("in/out factor lists must have equal length")

    @property
    def n(self) -> int:
        return len(self.in_factors)

    @property
    def in_dim(self) -> int:
        return math.prod(self.in_factors)

    @property
    def out_dim(self) -> int:
        return math.prod(self.out_factors)

    @property
    def central_index(self) -> int:
        return self.n // 2

    def full_bonds(self) -> tuple[int, ...]:
        """Exact (untruncated) bond dims d_1..d_{n-1}."""
        bonds = []
        for k in range(1, self.n):
            left = math.prod(self.in_factors[:k]) * math.prod(self.out_factors[:k])
            right = math.prod(self.in_factors[k:]) * math.prod(self.out_factors[k:])
            bonds.append(min(left, right))
        return tuple(bonds)

    def bonds(self) -> tuple[int, ...]:
        full = self.full_bonds()
        if self.bond_dim is None:
            return full
        return tuple(min(b, self.bond_dim) for b in full)

    def core_shapes(self) -> list[tuple[int, int, int, int]]:
        b = (1,) + self.bonds() + (1,)
        return [(b[k], self.in_factors[k], self.out_factors[k], b[k + 1])
                for k in range(self.n)]

    def num_params(self) -> int:
        return sum(math.prod(s) for s in self.core_shapes())

    def compression_ratio(self) -> float:
        """rho of Eq. (5): MPO params / original matrix params."""
        return self.num_params() / (self.in_dim * self.out_dim)

    @staticmethod
    def make(in_dim: int, out_dim: int, *, n: int = 5, bond_dim: int | None = None,
             in_multiple: int = 1, out_multiple: int = 1) -> "MPOSpec":
        return MPOSpec(
            in_factors=auto_factorize(in_dim, n, in_multiple, 0),
            out_factors=auto_factorize(out_dim, n, out_multiple, 0),
            bond_dim=bond_dim,
        )


# --------------------------------------------------------------------------
# contraction
# --------------------------------------------------------------------------


def _chain(cores: Sequence[torch.Tensor]) -> tuple[torch.Tensor, list[int]]:
    """The cores contracted along their bonds, ``(t, perm)``: ``t`` holds
    W's digits as (i1, j1, i2, j2, ..., in, jn) axes and ``t.permute(perm)``
    orders them (i1..in, j1..jn), the row-major ``W[I, J]``."""
    n = len(cores)
    ins = [c.shape[1] for c in cores]
    outs = [c.shape[2] for c in cores]
    if n == 1:
        return cores[0][0, :, :, 0], [0, 1]
    acc = cores[0][0]  # (i1, j1, d1)
    i1, j1 = ins[0], outs[0]
    mid = 1
    for c in cores[1:]:
        d0, ik, jk, d1 = c.shape
        acc = torch.einsum("abmd,dx->abmx", acc.reshape(i1, j1, mid, d0),
                           c.reshape(d0, ik * jk * d1))
        mid *= ik * jk
        acc = acc.reshape(i1, j1, mid, d1)
    # acc: (i1, j1, (i2 j2 ... in jn), 1) -> (I, J)
    rest = [x for k in range(1, n) for x in (ins[k], outs[k])]
    perm = ([0] + [2 + 2 * k for k in range(n - 1)]
            + [1] + [3 + 2 * k for k in range(n - 1)])
    return acc.reshape([i1, j1] + rest), perm


def reconstruct(cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """Contract cores back to the matrix ``W[I, J]``.

    Core 0's i/j legs stay separate leading axes through the chain, as the
    reference keeps them, so every intermediate rounds the same way."""
    t, perm = _chain(cores)
    return t.permute(perm).reshape(math.prod(c.shape[1] for c in cores),
                                   math.prod(c.shape[2] for c in cores))


def reconstruct_into(cores: Sequence[torch.Tensor], out: torch.Tensor) -> torch.Tensor:
    """``out.copy_(reconstruct(cores))`` — the same values, rounded once to
    ``out``'s dtype — without the contiguous (I, J) copy in the cores'
    dtype: the chain's last product is permuted straight into ``out``, so
    one matrix in the cores' dtype is all that lives beside it."""
    t, perm = _chain(cores)
    digits = [t.shape[p] for p in perm]
    out.view(digits).copy_(t.permute(perm))
    return out


def apply_mpo(cores: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``y[..., J] = x[..., I] @ W`` without materializing ``W`` (sequential
    contraction, one core at a time)."""
    outs = [c.shape[2] for c in cores]
    lead = x.shape[:-1]
    b = math.prod(lead) if lead else 1
    h = x.reshape(b, 1, -1)  # (Beff, d0, rest)
    for c in cores:
        d0, ik, jk, d1 = c.shape
        beff = h.shape[0]
        rest = h.shape[2] // ik
        h = h.reshape(beff, d0, ik, rest)
        h = torch.einsum("bdir,dijc->bjcr", h, c)
        h = h.reshape(beff * jk, d1, rest)
    return h.reshape(*lead, math.prod(outs))


def transpose_cores(cores: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Cores of ``W^T`` (swap the i/j legs of every core, stacked or not)."""
    return [c.transpose(-3, -2) for c in cores]


def apply_mpo_t(cores: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``y[..., I] = x[..., J] @ W^T`` (e.g. tied-embedding logits)."""
    return apply_mpo(transpose_cores(cores), x)


def reconstruct_stacked(cores: Sequence[torch.Tensor], dtype=None) -> torch.Tensor:
    """``reconstruct`` over any leading stacked dims (scanned layers): each
    matrix contracted on its own (``reconstruct_into``) into one
    preallocated ``(..., I, J)`` tensor in ``dtype`` (the cores' when None),
    so one matrix in the cores' dtype is all that lives beside it.  Cores
    without values (``meta`` or fake tensors: the linter's and the dry
    run's) give the allocated result alone, as there is nothing to
    contract."""
    from torch._subclasses.fake_tensor import is_fake
    lead = tuple(cores[0].shape[:-4])
    out = torch.empty(lead + (math.prod(c.shape[-3] for c in cores),
                              math.prod(c.shape[-2] for c in cores)),
                      dtype=cores[0].dtype if dtype is None else dtype,
                      device=cores[0].device)
    if cores[0].is_meta or is_fake(cores[0]):
        return out
    for idx in itertools.product(*map(range, lead)):
        reconstruct_into([c[idx] for c in cores], out[idx])
    return out


def embed_lookup(cores: Sequence[torch.Tensor], ids: torch.Tensor) -> torch.Tensor:
    """Row lookup ``W[ids, :]`` from a factorized embedding table.

    ``ids`` is split into mixed-radix digits over ``in_factors``; each digit
    selects a slice of its core, chained with small batched matmuls, so the
    full ``[vocab, d]`` table never materializes.  Selecting by index gives
    the values the reference's one-hot matmuls give."""
    ins = [c.shape[1] for c in cores]
    lead = ids.shape
    rem = ids.reshape(-1).long()
    digits = []
    for base in reversed(ins):
        digits.append(rem % base)
        rem = rem // base
    digits = digits[::-1]
    h = cores[0][0][digits[0]]                              # (B, j1, d1)
    for k in range(1, len(cores)):
        sel = cores[k][:, digits[k]].permute(1, 0, 2, 3)    # (B, d0, jk, d1)
        h = torch.einsum("bxd,bdje->bxje", h, sel)
        h = h.reshape(h.shape[0], -1, h.shape[-1])
    return h[..., 0].reshape(*lead, -1)


# --------------------------------------------------------------------------
# decomposition (Algorithm 1)
# --------------------------------------------------------------------------

# cuSOLVER's SVD on the card (``torch.linalg.svd``'s ``driver``): the
# QR-based ``gesvd``.  Converting full-width bert-base's exact tree it
# reconstructs every matrix within 2.4e-6 in 4.2 s, where Jacobi
# (``gesvdj``, 2.9 s) leaves 3.1e-4 at the embedding and ``gesvda`` fails
# to converge (PERF.md; ``tools/torch_lifecycle_profile.py``).  The CPU has
# one driver (LAPACK).
SVD_DRIVER = "gesvd"
# cuSOLVER's gesvd refuses the first unfolding of llava-next-34b's 64000 x
# 7168 vocabulary matrices (70 x 6553600 and 112 x 4096000:
# CUSOLVER_STATUS_INVALID_VALUE from the buffer-size query) and takes their
# second (5120 x 81920; PERF.md, Findings, from
# ``tools/torch_moe_train_profile.py``).  An unfolding of at least this many
# entries is reduced by a QR of its long side first, the small triangle then
# through gesvd (``_svd_qr``).
SVD_QR_ENTRIES = 2 ** 28


def _work(t: torch.Tensor) -> torch.Tensor:
    """float32 at least, as the reference casts (float64 stays float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _svd_qr(m: torch.Tensor, driver=None):
    """Reduced SVD of ``m`` (leading batch dims allowed) by a QR of its long
    side: ``a = q r`` with ``a`` = m or m^T (whichever is tall), then the SVD
    of the square ``r``; ``a = (q u) s vt``."""
    wide = m.shape[-2] < m.shape[-1]
    q, r = torch.linalg.qr(m.transpose(-2, -1) if wide else m)
    u, s, vt = torch.linalg.svd(r, full_matrices=False, driver=driver)
    u = q @ u
    if wide:
        return vt.transpose(-2, -1), s, u.transpose(-2, -1)
    return u, s, vt


def _svd(m: torch.Tensor):
    """Reduced SVD over leading batch dims, on ``m``'s device (on the card,
    through ``_svd_qr`` from ``SVD_QR_ENTRIES`` entries a matrix)."""
    if m.is_cuda and m.shape[-2] * m.shape[-1] >= SVD_QR_ENTRIES:
        return _svd_qr(m, SVD_DRIVER)
    return torch.linalg.svd(m, full_matrices=False,
                            driver=SVD_DRIVER if m.is_cuda else None)


def _interleave_perm(n: int) -> list[int]:
    """(i1..in, j1..jn) -> (i1, j1, i2, j2, ...)."""
    return [x for k in range(n) for x in (k, n + k)]


def decompose(matrix: torch.Tensor, spec: MPOSpec):
    """Algorithm 1: sequential-SVD MPO decomposition with bond truncation.

    ``matrix`` is ``(..., I, J)``; every core and spectrum keeps its leading
    dims.  Returns ``(cores, spectra)`` where ``spectra[k]`` holds the
    *pre-truncation* singular values seen at bond ``k`` (Eq. 3 errors,
    Eq. 6 entropy, squeeze candidates)."""
    n = spec.n
    m = _work(matrix)
    lead = tuple(m.shape[:-2])
    if tuple(m.shape[-2:]) != (spec.in_dim, spec.out_dim):
        raise ValueError(f"matrix {tuple(m.shape)} != spec (..., {spec.in_dim}, {spec.out_dim})")
    nl = len(lead)
    t = m.reshape(*lead, *spec.in_factors, *spec.out_factors)
    t = t.permute(*range(nl), *[nl + p for p in _interleave_perm(n)])
    bonds = spec.bonds()
    cores, spectra = [], []
    d_prev = 1
    rem = t.reshape(*lead, -1)
    for k in range(n - 1):
        rows = d_prev * spec.in_factors[k] * spec.out_factors[k]
        u, s, vt = _svd(rem.reshape(*lead, rows, -1))
        dk = min(bonds[k], s.shape[-1])
        spectra.append(s)
        cores.append(u[..., :dk].reshape(*lead, d_prev, spec.in_factors[k],
                                         spec.out_factors[k], dk))
        rem = (s[..., :dk, None] * vt[..., :dk, :]).reshape(*lead, -1)
        d_prev = dk
    cores.append(rem.reshape(*lead, d_prev, spec.in_factors[-1], spec.out_factors[-1], 1))
    return cores, spectra


# --------------------------------------------------------------------------
# truncation errors / entropy (Eq. 3, 4, 6), over leading batch dims
# --------------------------------------------------------------------------


def local_truncation_error(spectrum: torch.Tensor, keep: int) -> torch.Tensor:
    """eps_k — Frobenius-optimal local truncation error at one bond: the l2
    norm of the discarded tail (the Eckart–Young quantity in Eq. 4's bound;
    ``paper_epsilon`` is Eq. 3's literal sum)."""
    tail = spectrum[..., keep:]
    return torch.sqrt((tail * tail).sum(-1))


def paper_epsilon(spectrum: torch.Tensor, keep: int) -> torch.Tensor:
    """Literal Eq. (3): sum of discarded singular values."""
    return spectrum[..., keep:].sum(-1)


def total_error_bound(spectra: Sequence[torch.Tensor], keeps: Sequence[int]) -> torch.Tensor:
    """Eq. (4) right-hand side: sqrt(sum_k eps_k^2)."""
    return torch.sqrt(sum(local_truncation_error(s, k) ** 2 for s, k in zip(spectra, keeps)))


def entanglement_entropy(spectrum: torch.Tensor) -> torch.Tensor:
    """Eq. (6): S = -sum v ln v with v = normalized singular values."""
    v = spectrum / spectrum.sum(-1, keepdim=True)
    pos = v > 0
    return -torch.where(pos, v * torch.log(torch.where(pos, v, 1.0)), 0.0).sum(-1)


# --------------------------------------------------------------------------
# TT-rounding (used by dimension squeezing on *trained* cores)
# --------------------------------------------------------------------------


def right_orthogonalize(cores: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Sweep n..2 making every core right-orthogonal (an LQ decomposition as
    the QR of the transpose); leading dims are a batch."""
    out = [_work(c) for c in cores]
    for k in range(len(out) - 1, 0, -1):
        c = out[k]
        lead = c.shape[:-4]
        q, r = torch.linalg.qr(c.reshape(*lead, c.shape[-4], -1).transpose(-1, -2))
        out[k] = q.transpose(-1, -2).reshape(*lead, q.shape[-1], *c.shape[-3:])
        out[k - 1] = torch.einsum("...aijb,...cb->...aijc", out[k - 1], r)
    return out


def _sweep(cores: Sequence[torch.Tensor], new_bonds: Sequence[int] | None):
    """Right-orthogonalize, then a left->right SVD sweep, truncating bond k
    to ``new_bonds[k]`` (None: keep every bond).  Returns ``(cores,
    spectra)``, the spectra taken before truncation."""
    cs = right_orthogonalize(cores)
    out, spectra, carry = [], [], None
    for k in range(len(cs) - 1):
        c = cs[k] if carry is None else torch.einsum("...ab,...bijc->...aijc", carry, cs[k])
        u, s, vt = _svd(c.reshape(*c.shape[:-4], -1, c.shape[-1]))
        spectra.append(s)
        dk = s.shape[-1] if new_bonds is None else min(int(new_bonds[k]), s.shape[-1])
        out.append(u[..., :dk].reshape(*c.shape[:-1], dk))
        carry = s[..., :dk, None] * vt[..., :dk, :]
    out.append(cs[-1] if carry is None
               else torch.einsum("...ab,...bijc->...aijc", carry, cs[-1]))
    return out, spectra


def bond_spectra(cores: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Singular values at every bond of the *current* (possibly trained) MPO."""
    return _sweep(cores, None)[1]


def tt_round(cores: Sequence[torch.Tensor], new_bonds: Sequence[int]):
    """Truncate an existing MPO to ``new_bonds`` (Oseledets TT-rounding):
    right-orthogonalize, then a left->right truncated-SVD sweep.  Returns
    ``(new_cores, spectra)``, the spectra pre-truncation (Eq. 3/4 and the
    squeeze's candidates)."""
    return _sweep(cores, new_bonds)


def _deinterleave_perm(n: int) -> list[int]:
    """(i1, j1, i2, j2, ...) -> (i1..in, j1..jn)."""
    return [2 * k for k in range(n)] + [2 * k + 1 for k in range(n)]


def reconstruct_merged(cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """The reference's legacy chain staging (rows merged as it goes): the
    values of ``reconstruct``; the reconstruct-mode backward projects dW
    into core space through its VJP, as the reference does."""
    n = len(cores)
    ins = [c.shape[1] for c in cores]
    outs = [c.shape[2] for c in cores]
    acc = cores[0].reshape(-1, cores[0].shape[-1])  # (i1*j1, d1)
    for c in cores[1:]:
        acc = (acc @ c.reshape(c.shape[0], -1)).reshape(-1, c.shape[-1])
    t = acc.reshape([x for k in range(n) for x in (ins[k], outs[k])])
    return t.permute(_deinterleave_perm(n)).reshape(math.prod(ins), math.prod(outs))


def _project_dw(cores: Sequence[torch.Tensor], x: torch.Tensor,
                dy: torch.Tensor) -> list[torch.Tensor]:
    """dcores from ``dW = x^T dy`` projected into core space.  ``x`` and
    ``dy`` come in bf16 and dW leaves in bf16, as the reference's einsum of
    two bf16 operands does (products exact in f32, one f32 sum, one
    rounding), then in the cores' dtype through ``reconstruct_merged``."""
    dw = (x.reshape(-1, x.shape[-1]).float().T
          @ dy.reshape(-1, dy.shape[-1]).float()).to(x.dtype)
    with torch.enable_grad():
        cs = [c.detach().requires_grad_() for c in cores]
        return list(torch.autograd.grad(reconstruct_merged(cs), cs, dw.to(cores[0].dtype)))


def _stacked_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for one matrix, or each of a stack's ``(E, I, J)`` matrices
    on its own rows of x ``(E, ..., I)``."""
    if w.dim() == 2:
        return x @ w
    return (x.reshape(w.shape[0], -1, w.shape[1]) @ w).reshape(*x.shape[:-1], w.shape[2])


class _MatmulReconstruct(torch.autograd.Function):
    """The reference's ``matmul_reconstruct`` custom VJP: dense forward,
    backward that recomputes W for ``dx = dy @ W^T`` and projects the
    bf16-cast ``dW`` into core space (``_mm_recon_bwd``).  Over a stack
    (5-D cores, x ``(E, ..., I)``: a MoE layer's experts, which the
    reference runs under ``jax.vmap``) each matrix's dW comes from its own
    rows."""

    @staticmethod
    def forward(ctx, x, *cores):
        ctx.save_for_backward(x, *cores)
        return _stacked_product(x, reconstruct_stacked(cores))

    @staticmethod
    def backward(ctx, dy):
        x, *cores = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _stacked_product(dy, reconstruct_stacked(cores).transpose(-1, -2))
        dcores = [None] * len(cores)
        if any(ctx.needs_input_grad[1:]):
            xb, dyb = x.to(torch.bfloat16), dy.to(torch.bfloat16)
            if cores[0].dim() == 4:
                dcores = _project_dw(cores, xb, dyb)
            else:
                per = [_project_dw([c[e] for c in cores], xb[e], dyb[e])
                       for e in range(cores[0].shape[0])]
                dcores = [torch.stack(g) for g in zip(*per)]
        return (dx, *dcores)


def matmul_reconstruct(x: torch.Tensor, cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """``x @ reconstruct(cores)`` — dense forward, core-space backward (the
    reference's ``matmul_reconstruct``); 5-D cores are a stack of matrices,
    each applied to its own rows of x ``(E, ..., I)``."""
    return _MatmulReconstruct.apply(x, *cores)


# --------------------------------------------------------------------------
# initialization
# --------------------------------------------------------------------------


def init_cores(gen: torch.Generator, spec: MPOSpec, *, scale: float | None = None,
               dtype=torch.float32) -> list[torch.Tensor]:
    """Random cores such that ``reconstruct(cores)`` has fan-in variance.

    An entry of W sums ``prod(bonds)`` products of ``n`` core entries, so
    the per-core std is ``(var_W / prod(bonds)) ** (1 / (2n))``.  Drawn
    from ``gen`` on its device (the CPU's generator in the models' default
    init); the caller moves them."""
    if torch.get_default_device().type == "meta":      # shapes only
        return [torch.empty(s, dtype=dtype) for s in spec.core_shapes()]
    var_w = (scale ** 2) if scale is not None else 1.0 / spec.in_dim
    prod_bonds = math.prod(spec.bonds()) if spec.n > 1 else 1.0
    sigma = (var_w / prod_bonds) ** (1.0 / (2 * spec.n))
    return [sigma * randn(s, gen, dtype) for s in spec.core_shapes()]


def randn(shape, gen: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """``torch.randn`` from ``gen``: on the card for a card's generator; a
    CPU generator's draw goes to the default device, so that under
    ``torch.device("meta")`` an init builds its shapes and draws nothing."""
    if torch.get_default_device().type == "meta":
        return torch.empty(shape, dtype=dtype)
    kw = {} if gen.device.type == "cpu" else {"device": gen.device}
    return torch.randn(shape, generator=gen, dtype=dtype, **kw)


def count_params(cores: Sequence[torch.Tensor]) -> int:
    return sum(c.numel() for c in cores)
