"""Error-feedback gradient compression — the port of ``repro.optim.compress``.

EF-int8 (per-tensor scale, round to nearest even) and EF-top-k.  The
compressor runs *before* the optimizer: the update consumes the
dequantized gradient, and the quantization residual is fed back into the
next step's gradient (Seide et al. 1-bit SGD / EF-SGD), which preserves
convergence.  With LFA masking the frozen central cores carry no error
state at all (``None`` in their place, as the optimizers keep none).

On a mesh the gradients are DTensors with their parameters' placements:
int8's scale is the max over every shard, and top-k picks the k largest of
the whole gradient.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.lightweight import tree_map
from repro_torch.optim.optimizers import Optimizer, OptState


class CompressState(NamedTuple):
    error: Any          # residual tree (None for frozen leaves)
    inner: OptState


def _q_int8(g):
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_int8(g, err):
    """(compressed-then-decompressed grad, new residual), f32."""
    g32 = g.float() + err
    q, scale = _q_int8(g32)
    deq = q.float() * scale
    return deq, g32 - deq


def ef_topk(g, err, frac: float = 0.01):
    """Keep the ``max(1, int(frac * n))`` largest-magnitude entries of the
    error-corrected gradient; the rest is the new residual."""
    from repro_torch.parallel import spmd
    g32 = g.float() + err
    whole = g32.full_tensor() if spmd.is_dtensor(g32) else g32
    flat = whole.reshape(-1)
    k = max(1, int(frac * flat.shape[0]))
    idx = torch.topk(flat.abs(), k).indices
    kept = torch.zeros_like(flat)
    kept[idx] = flat[idx]
    deq = kept.reshape(whole.shape)
    if spmd.is_dtensor(g32):
        from repro_torch.parallel.sharding import place
        deq = place(deq, g32.device_mesh, g32.placements)
    return deq, g32 - deq


def wrap_compression(opt: Optimizer, *, kind: str = "int8", topk_frac: float = 0.01,
                     mask=None) -> Optimizer:
    """Wrap an optimizer so the gradients pass through EF compression first.
    ``mask`` (True = trainable) gives frozen leaves no error state; their
    gradients pass through untouched."""
    if kind not in ("int8", "topk"):
        raise ValueError(f"compression kind {kind!r}: int8 | topk")

    def comp(g, e):
        return ef_int8(g, e) if kind == "int8" else ef_topk(g, e, topk_frac)

    def _mask(params):
        return mask if mask is not None else tree_map(lambda _: True, params)

    def init(params):
        err = tree_map(lambda p, t: torch.zeros_like(p, dtype=torch.float32) if t else None,
                       params, _mask(params))
        return CompressState(err, opt.init(params))

    @torch.no_grad()
    def update(grads, state, params):
        outs = tree_map(lambda g, e, t: comp(g, e) if t else (g, None), grads, state.error,
                        _mask(params))
        inner = opt.update(_first(outs), state.inner, params)
        return CompressState(_second(outs), inner)

    return Optimizer(init, update)


def _first(tree):
    """The first of each leaf pair of a tree of (grad, residual) pairs."""
    return {k: _first(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[0]


def _second(tree):
    return {k: _second(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[1]
