"""Matrix Product Operator (MPO) primitives — the port of ``repro.core.mpo``.

A matrix ``M[I, J]`` with ``I = prod(in_factors)``, ``J = prod(out_factors)``
is held as ``n`` 4-order cores ``T_k[d_{k-1}, i_k, j_k, d_k]`` with
``d_0 = d_n = 1``.  Row/col indices are row-major: core 0's digits are the
most significant.  The *central* core is ``k = n // 2``; the rest are
*auxiliary*.

Two execution paths for ``y = x @ MPO(W)``:

  * ``apply_mpo``   — factorized sequential contraction;
  * ``reconstruct`` — contract W once, then a dense matmul.

The sequential-SVD decomposition, truncation errors and TT-rounding come
with conversion and squeezing (ROADMAP.md, Queue 1 item 2).
"""

from __future__ import annotations

import dataclasses
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


def reconstruct(cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """Contract cores back to the matrix ``W[I, J]``.

    Core 0's i/j legs stay separate leading axes through the chain, as the
    reference keeps them, so every intermediate rounds the same way."""
    n = len(cores)
    ins = [c.shape[1] for c in cores]
    outs = [c.shape[2] for c in cores]
    if n == 1:
        return cores[0][0, :, :, 0]
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
    t = acc.reshape([i1, j1] + rest)
    perm = ([0] + [2 + 2 * k for k in range(n - 1)]
            + [1] + [3 + 2 * k for k in range(n - 1)])
    return t.permute(perm).reshape(math.prod(ins), math.prod(outs))


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
    """Cores of ``W^T`` (swap the i/j legs of every core)."""
    return [c.permute(0, 2, 1, 3) for c in cores]


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


class _MatmulReconstruct(torch.autograd.Function):
    """The reference's ``matmul_reconstruct`` custom VJP: dense forward,
    backward that recomputes W for ``dx = dy @ W^T`` and projects the
    bf16-cast ``dW`` into core space (``_mm_recon_bwd``)."""

    @staticmethod
    def forward(ctx, x, *cores):
        ctx.save_for_backward(x, *cores)
        return x @ reconstruct(list(cores))

    @staticmethod
    def backward(ctx, dy):
        x, *cores = ctx.saved_tensors
        dx = dy @ reconstruct(cores).T if ctx.needs_input_grad[0] else None
        dcores = [None] * len(cores)
        if any(ctx.needs_input_grad[1:]):
            dcores = _project_dw(cores, x.to(torch.bfloat16), dy.to(torch.bfloat16))
        return (dx, *dcores)


def matmul_reconstruct(x: torch.Tensor, cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """``x @ reconstruct(cores)`` — dense forward, core-space backward (the
    reference's ``matmul_reconstruct``)."""
    return _MatmulReconstruct.apply(x, *cores)


# --------------------------------------------------------------------------
# initialization
# --------------------------------------------------------------------------


def init_cores(gen: torch.Generator, spec: MPOSpec, *, scale: float | None = None,
               dtype=torch.float32) -> list[torch.Tensor]:
    """Random cores such that ``reconstruct(cores)`` has fan-in variance.

    An entry of W sums ``prod(bonds)`` products of ``n`` core entries, so
    the per-core std is ``(var_W / prod(bonds)) ** (1 / (2n))``.  Drawn on
    the CPU from ``gen``; the caller moves them."""
    var_w = (scale ** 2) if scale is not None else 1.0 / spec.in_dim
    prod_bonds = math.prod(spec.bonds()) if spec.n > 1 else 1.0
    sigma = (var_w / prod_bonds) ** (1.0 / (2 * spec.n))
    return [sigma * torch.randn(s, generator=gen, dtype=dtype)
            for s in spec.core_shapes()]


def count_params(cores: Sequence[torch.Tensor]) -> int:
    return sum(c.numel() for c in cores)
