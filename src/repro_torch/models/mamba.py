"""Mamba2 (SSD, state-space duality) blocks and the pure-SSM model — the port
of ``repro.models.mamba``.

Reference: Dao & Gu, "Transformers are SSMs" (arXiv:2405.21060).  The chunked
SSD scan (intra-chunk quadratic term + inter-chunk state recurrence) runs
through ``kernels.ssd_scan.SSDScanFn``: the hand-written forward and backward
kernels on the card, their plain versions (the reference's ``ssd_chunked``
and its gradients) on the CPU.  The one-token decode
recurrence is plain tensor code, as the reference computes it outside any
kernel.  in_proj / out_proj are MPO-factorized and go through the engine;
the SSD scalars (A_log, D, dt_bias) are vectors and stay dense.

The layer stack is a Python loop over the stacked layer params (the
reference scans them).  The SSM state is one ``(L, B, H, N, P)`` f32 tensor;
prefill and decode write each layer's new state into it in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import layers as L
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.kernels.ssd_scan import segsum, ssd_decode_step  # noqa: F401  (the reference's names)
from repro_torch.models import nn
from repro_torch.parallel import spmd

# --------------------------------------------------------------------------
# SSD core
# --------------------------------------------------------------------------


def ssd_chunked(x, dt, a_log, b, c, d_skip, chunk: int):
    """Chunked SSD scan -> ``(y (B, S, H, P) in x's dtype, final state
    (B, H, N, P) f32)``.  x (B, S, H, P); dt (B, S, H) softplus-activated;
    a_log, d_skip (H,); b, c (B, S, N).  The inputs are made contiguous
    here: in_proj's slices are strided views, which the kernel refuses.

    A sequence longer than a chunk and not a whole number of chunks (the
    reference asserts it is one; a pool admits prompts of any length) is
    padded at the end to one, with dt = 0 there: a step of dt = 0 neither
    decays the state (exp(0) = 1) nor adds to it, so the real positions'
    outputs and the final state are the unpadded sequence's, in one scan.
    ``F.pad`` carries the gradients back to the real positions: the padded
    ones' gradients are dropped with them."""
    s = x.shape[1]
    pad = -s % chunk if s > chunk else 0
    if pad:
        x, b, c = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, b, c))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, state = SSD.ssd_scan(x.contiguous(), dt.float().contiguous(), a_log.float().contiguous(),
                            b.contiguous(), c.contiguous(), d_skip.float().contiguous(), chunk)
    return (y[:, :s] if pad else y), state


def ssd_reference(x, dt, a_log, b, c, d_skip):
    """Naive O(S) sequential recurrence — the oracle of the tests."""
    return SSD.ssd_scan_ref(x, dt, a_log, b, c, d_skip)[0]


# --------------------------------------------------------------------------
# Mamba2 block
# --------------------------------------------------------------------------


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj_out = 2 * di + 2 * n + h   # [z, x, B, C, dt]
    return {
        "norm": nn.init_rmsnorm(d),
        "in_proj": L.init_linear(gen, d, proj_out, cfg=cfg.mpo, kind="ffn",
                                 out_axis="ffn", sharded_out=True),
        "out_proj": L.init_linear(gen, di, d, cfg=cfg.mpo, kind="ffn",
                                  in_axis="ffn", sharded_in=True, scale=di ** -0.5),
        "a_log": L.annot(torch.zeros(h), (None,)),
        "d_skip": L.annot(torch.ones(h), (None,)),
        "dt_bias": L.annot(torch.zeros(h), (None,)),
        "out_norm": nn.init_rmsnorm(di),
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xs = zxbcdt[..., di:2 * di]
    b = zxbcdt[..., 2 * di:2 * di + n]
    c = zxbcdt[..., 2 * di + n:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, xs, b, c, dt


def apply_mamba_block(params, x, cfg: ModelConfig, *, state=None,
                      decode: bool = False, phase: str = "train"):
    """Returns ``(y, new_state)``.  ``decode=True`` -> single-token recurrence
    from ``state`` (B, H, N, P), which it advances in place and returns."""
    bsz = x.shape[0]
    di, h, p = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    res = x
    hmid = nn.apply_rmsnorm(params["norm"], x)
    zxbcdt = L.apply_linear(params["in_proj"], hmid, cfg=cfg.mpo, phase=phase)
    z, xs, b, c, dt = _split_proj(cfg, zxbcdt)
    dt = F.softplus(dt.float() + params["dt_bias"])
    xs = xs.reshape(xs.shape[:-1] + (h, p))
    if not decode:
        y, new_state = ssd_chunked(xs, dt, params["a_log"], b, c, params["d_skip"],
                                   cfg.ssm_chunk)
    else:
        y = _decode_step(state, xs[:, 0], dt[:, 0], params["a_log"], b[:, 0], c[:, 0],
                         params["d_skip"])[:, None]
        new_state = state
    y = y.reshape(bsz, -1, di)
    y = nn.apply_rmsnorm(params["out_norm"], y) * F.silu(z.float()).to(y.dtype)
    out = L.apply_linear(params["out_proj"], y, cfg=cfg.mpo, phase=phase)
    return res + out.to(res.dtype), new_state


def _decode_step(state, x_t, dt_t, a_log, b_t, c_t, d_skip):
    """``ssd_decode_step`` with ``state`` advanced in place; returns y
    (B, H, P).  On a mesh the state is spread as
    ``parallel.sharding.cache_spec`` lays it out (batch over ``data``, N —
    else H — over ``model``): each rank advances its own block and reads y
    from it, an N split sums the partial reads over ``model``, then the
    heads and rows are gathered.  A plain state is its own block."""
    sl = spmd.local(state)
    (b0, b1), (h0, h1), (n0, n1) = (spmd.local_range(state, d) for d in range(3))
    da = torch.exp(-torch.exp(a_log.float()) * dt_t.float())[b0:b1, h0:h1]
    xw = (x_t.float() * dt_t[..., None])[b0:b1, h0:h1]
    new = sl * da[..., None, None] + torch.einsum("bn,bhp->bhnp",
                                                  b_t.float()[b0:b1, n0:n1], xw)
    sl.copy_(new)
    y = torch.einsum("bn,bhnp->bhp", c_t.float()[b0:b1, n0:n1], new)
    if spmd.sharded_over(state, 2, "model"):
        y = spmd.reduce(y, state.device_mesh)
    y = y + x_t.float()[b0:b1, h0:h1] * d_skip[h0:h1][None, :, None]
    if spmd.sharded_over(state, 1, "model"):
        y = spmd.gather(y, 1, state.device_mesh)
    return spmd.gather_batch(y, 0, state).to(x_t.dtype)


def init_ssm_state(cfg: ModelConfig, batch: int, *, device=None) -> torch.Tensor:
    return torch.zeros((cfg.num_layers, batch, cfg.ssm_heads, cfg.ssm_state,
                        cfg.ssm_head_dim), dtype=torch.float32, device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, paged: bool = False,
               device=None, **_) -> torch.Tensor:
    """The serving cache of the family: the SSM state, whose size does not
    depend on ``max_len``.  There is no KV sequence to page, so ``paged=True``
    raises, as the reference's ``init_cache`` does."""
    if paged:
        raise ValueError("paged KV cache requires an attention KV cache; "
                         "family 'ssm' has none")
    return init_ssm_state(cfg, batch, device=device)


def reset_cache(state: torch.Tensor) -> torch.Tensor:
    """Rewind the SSM state made by ``init_cache`` to zeros, in place."""
    return state.zero_()


# --------------------------------------------------------------------------
# pure-SSM model (mamba2-130m)
# --------------------------------------------------------------------------


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, cfg=cfg.mpo),
        "layers": nn.stack_layers(lambda g: init_mamba_block(g, cfg), gen, cfg.num_layers),
        "final_norm": nn.init_rmsnorm(cfg.d_model),
    }


def _embed(params, tokens, cfg: ModelConfig, phase: str):
    x = L.apply_embedding(params["embed"], tokens, cfg=cfg.mpo, dtype=cfg.torch_dtype,
                          phase=phase)
    return x.to(cfg.torch_dtype)


def forward_hidden(params, batch, cfg: ModelConfig, *, phase="train"):
    """Teacher-forced forward up to the final norm -> hidden (B, S, D); each
    layer recomputed in the backward when ``cfg.remat`` and gradients are
    being taken."""
    x = _embed(params, batch["tokens"], cfg, phase)

    def body(x, layer):
        return apply_mamba_block(layer, x, cfg, phase=phase)[0]

    for i in range(cfg.num_layers):
        layer = nn.index_layer(params["layers"], i)
        if cfg.remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(body, x, layer, use_reentrant=False)
        else:
            x = body(x, layer)
    return nn.apply_rmsnorm(params["final_norm"], x)


def logits_head(params, hidden, cfg: ModelConfig, *, phase="train"):
    return L.apply_logits(params["embed"], hidden, cfg=cfg.mpo, phase=phase)


def forward(params, batch, cfg: ModelConfig, *, phase="train"):
    """Teacher-forced forward -> logits (B, S, V)."""
    return logits_head(params, forward_hidden(params, batch, cfg, phase=phase), cfg,
                       phase=phase)


def prefill(params, batch, state, cfg: ModelConfig, *, phase="prefill"):
    """SSM prefill: the chunked scan from a zero state (the incoming state's
    values are not read, as the reference's prefill ignores them); each
    layer's final state is written into ``state`` (L, B, H, N, P) in place.
    Returns (last-position logits (B, 1, V), state)."""
    x = _embed(params, batch["tokens"], cfg, phase)
    for i in range(cfg.num_layers):
        x, final_state = apply_mamba_block(nn.index_layer(params["layers"], i), x, cfg,
                                           phase=phase)
        spmd.write_block(state[i], final_state)
    x = nn.apply_rmsnorm(params["final_norm"], x)
    return L.apply_logits(params["embed"], x[:, -1:], cfg=cfg.mpo, phase=phase), state


def decode_step(params, tokens, state, cfg: ModelConfig, *, phase="decode"):
    """tokens (B, 1); state (L, B, H, N, P), advanced in place.  Returns
    (logits (B, 1, V), state)."""
    x = _embed(params, tokens, cfg, phase)
    for i in range(cfg.num_layers):
        x, _ = apply_mamba_block(nn.index_layer(params["layers"], i), x, cfg,
                                 state=state[i], decode=True, phase=phase)
    x = nn.apply_rmsnorm(params["final_norm"], x)
    return L.apply_logits(params["embed"], x, cfg=cfg.mpo, phase=phase), state
