"""Masked optimizers — the port of ``repro.optim.optimizers``.

Masked-out leaves (the frozen central tensors under lightweight fine-tuning)
allocate **no optimizer state** (``None`` in their place) and receive **no
update**.  State is float32 whatever the parameters' dtype.  ``update``
writes the new parameter values into the parameters IN PLACE (under
``no_grad``) and returns the new state; the reference returns new arrays.
Parameters and gradients are nested dicts of tensors with the same keys::

    opt = adamw(2e-3, mask=trainable_mask(params, mode="lfa"))
    state = opt.init(params)
    state = opt.update(grads, state, params)      # params now updated
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.lightweight import leaves, tree_map


class OptState(NamedTuple):
    step: int
    inner: Any          # per-leaf state dict (None for frozen leaves)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable      # params -> OptState
    update: Callable    # (grads, state, params) -> new state; params updated in place


def _mask_tree(params, mask):
    return tree_map(lambda _: True, params) if mask is None else mask


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _replicated_like(p, t: torch.Tensor):
    """``t`` as ``p`` holds a factored statistic: on ``p``'s mesh,
    replicated, when ``p`` is a DTensor."""
    from repro_torch.parallel.spmd import is_dtensor
    if not is_dtensor(p):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = p.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _apply(params, grads, inner, mask, upd) -> Any:
    """Run ``upd(p, g, s) -> (new_p, new_s)`` over the trainable leaves,
    write ``new_p`` into ``p`` (the callers run under ``no_grad``) and
    return the new state tree."""

    def one(p, g, s, t):
        if not t:
            return None
        new_p, new_s = upd(p, g, s)
        p.copy_(new_p)
        return new_s

    return tree_map(one, params, grads, inner, mask)


def adamw(lr: Callable | float, *, b1=0.9, b2=0.999, eps=1e-8,
          weight_decay=0.0, mask=None, state_dtype=torch.float32,
          grad_clip: float | None = 1.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        m = _mask_tree(params, mask)
        inner = tree_map(lambda p, t: {"mu": torch.zeros_like(p, dtype=state_dtype),
                                       "nu": torch.zeros_like(p, dtype=state_dtype)}
                         if t else None, params, m)
        return OptState(0, inner)

    @torch.no_grad()
    def update(grads, state, params):
        m = _mask_tree(params, mask)
        step = state.step + 1
        lr_t = lr_fn(step)
        if grad_clip is not None:
            # the clip norm runs over the trainable leaves only
            sq = [g.float().square().sum() for g, t in zip(leaves(grads), leaves(m)) if t]
            gnorm = torch.sqrt(sum(sq)) if sq else torch.zeros(())
            scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
        else:
            scale = 1.0
        bc1 = 1 - _f32(b1) ** _f32(step)
        bc2 = 1 - _f32(b2) ** _f32(step)

        def upd(p, g, s):
            g = g.float() * scale
            mu = b1 * s["mu"] + (1 - b1) * g
            nu = b2 * s["nu"] + (1 - b2) * g * g
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            u = u + weight_decay * p.float()
            new_p = (p.float() - lr_t * u).to(p.dtype)
            return new_p, {"mu": mu.to(state_dtype), "nu": nu.to(state_dtype)}

        return OptState(step, _apply(params, grads, state.inner, m, upd))

    return Optimizer(init, update)


def adafactor(lr: Callable | float, *, eps=1e-30, clip=1.0, mask=None,
              weight_decay: float = 0.0) -> Optimizer:
    """Memory-efficient second-moment factorization (Shazeer & Stern)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        m = _mask_tree(params, mask)

        def one(p, t):
            if not t:
                return None
            z = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": _replicated_like(p, torch.zeros(p.shape[:-1], **z)),
                        "vc": _replicated_like(p, torch.zeros(p.shape[:-2] + p.shape[-1:],
                                                              **z))}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}

        return OptState(0, tree_map(one, params, m))

    @torch.no_grad()
    def update(grads, state, params):
        m = _mask_tree(params, mask)
        step = state.step + 1
        lr_t = lr_fn(step)
        beta = 1.0 - (_f32(step) + 1.0) ** -0.8

        def upd(p, g, s):
            g = g.float()
            g2 = g * g + eps
            if p.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(-2)
                rms_r = vr / vr.mean(-1, keepdim=True)
                u = g * torch.rsqrt(rms_r)[..., None] * torch.rsqrt(vc)[..., None, :]
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v)
                new_s = {"v": v}
            u = u / torch.clamp(torch.sqrt((u * u).mean()) / clip, min=1.0)
            u = u + weight_decay * p.float()
            return (p.float() - lr_t * u).to(p.dtype), new_s

        return OptState(step, _apply(params, grads, state.inner, m, upd))

    return Optimizer(init, update)


def sgdm(lr: Callable | float, *, momentum=0.9, mask=None) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        m = _mask_tree(params, mask)
        return OptState(0, tree_map(
            lambda p, t: torch.zeros_like(p, dtype=torch.float32) if t else None, params, m))

    @torch.no_grad()
    def update(grads, state, params):
        m = _mask_tree(params, mask)
        step = state.step + 1
        lr_t = lr_fn(step)

        def upd(p, g, s):
            v = momentum * s + g.float()
            return (p.float() - lr_t * v).to(p.dtype), v

        return OptState(step, _apply(params, grads, state.inner, m, upd))

    return Optimizer(init, update)
