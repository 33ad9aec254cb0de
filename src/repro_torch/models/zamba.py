"""Zamba2-style hybrid: Mamba2 blocks and *shared* attention blocks — the
port of ``repro.models.zamba``.

The ``num_layers`` Mamba2 blocks run in ``num_layers / attn_every``
segments of ``attn_every`` blocks; ahead of each segment one of the
``num_shared_attn`` parameter-shared transformer blocks is applied (segment
``s`` takes block ``s % num_shared_attn``), so a shared block's matrices
are used once a segment that names it and their gradients sum over those
uses.  The Mamba2 blocks are ``models.mamba``'s (the SSD scan through
``kernels.ssd_scan.SSDScanFn``); the shared block's attention is
``models.nn``'s over a dense KV cache with ONE position a segment (a 0-d
``pos``, as the reference's), its MLP a plain GELU.

The serving cache is ``{"kv": {"k", "v": (nseg, B, max_len, KV, Dh), "pos":
(nseg,) int32}, "ssm": (L, B, H, N, P) f32}``; prefill and decode write it
in place.  It is not paged (``paged=True`` raises, as the reference's
``init_cache`` does), and there is no incremental prefill.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import layers as L
from repro_torch.models import mamba, nn, transformer
from repro_torch.parallel import spmd


def num_segments(cfg: ModelConfig) -> int:
    if cfg.num_layers % cfg.attn_every:
        raise ValueError(f"num_layers {cfg.num_layers} is not a multiple of attn_every "
                         f"{cfg.attn_every}")
    return cfg.num_layers // cfg.attn_every


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The reference's tree: ``embed``, ``mamba`` (stacked ``num_layers``),
    ``shared_attn`` (stacked ``num_shared_attn``) and ``final_norm``."""
    def shared_block(g):
        return {"ln": nn.init_rmsnorm(cfg.d_model),
                "attn": nn.init_attention(g, transformer.attn_cfg(cfg), cfg.mpo),
                "ln2": nn.init_rmsnorm(cfg.d_model),
                "mlp": nn.init_mlp(g, cfg.d_model, cfg.d_ff, "gelu_plain", cfg.mpo)}

    return {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, cfg=cfg.mpo),
        "mamba": nn.stack_layers(lambda g: mamba.init_mamba_block(g, cfg), gen,
                                 cfg.num_layers),
        "shared_attn": nn.stack_layers(shared_block, gen, cfg.num_shared_attn),
        "final_norm": nn.init_rmsnorm(cfg.d_model),
    }


def _shared_attn_fwd(cfg: ModelConfig, shared, idx: int, x, *, positions, mask, cache=None,
                     phase="train"):
    """Shared block ``idx % num_shared_attn``: attention and a GELU MLP,
    each behind an RMSNorm and a residual.  ``cache``: the segment's dense
    KV cache (0-d ``pos``), updated in place."""
    block = nn.index_layer(shared, idx % cfg.num_shared_attn)
    h = nn.apply_rmsnorm(block["ln"], x)
    a, _ = nn.apply_attention(block["attn"], h, transformer.attn_cfg(cfg), cfg.mpo,
                              positions=positions, mask=mask, cache=cache, phase=phase)
    x = x + a
    h = nn.apply_rmsnorm(block["ln2"], x)
    return x + nn.apply_mlp(block["mlp"], h, "gelu_plain", cfg.mpo, phase=phase)


def _stack(cfg: ModelConfig, params, x, *, positions, mask, cache=None, decode=False,
           phase="train"):
    """[shared block, ``attn_every`` Mamba2 blocks] once a segment.  With
    ``cache`` every segment's KV cache and every layer's SSM state are
    written in place: a prefill's final states, or a decode step's
    advanced ones."""
    per = cfg.attn_every

    def body(x, layer):
        return mamba.apply_mamba_block(layer, x, cfg, phase=phase)[0]

    for s in range(num_segments(cfg)):
        kv = None if cache is None else nn.index_layer(cache["kv"], s)
        x = _shared_attn_fwd(cfg, params["shared_attn"], s, x, positions=positions,
                             mask=mask, cache=kv, phase=phase)
        for i in range(s * per, (s + 1) * per):
            layer = nn.index_layer(params["mamba"], i)
            if cache is not None:
                state = cache["ssm"][i]
                x, new_state = mamba.apply_mamba_block(layer, x, cfg, state=state,
                                                       decode=decode, phase=phase)
                if not decode:                     # a decode advances it in place
                    spmd.write_block(state, new_state)
            elif cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(body, x, layer, use_reentrant=False)
            else:
                x = body(x, layer)
    return x


def _embed(params, tokens, cfg: ModelConfig, phase: str):
    x = L.apply_embedding(params["embed"], tokens, cfg=cfg.mpo, dtype=cfg.torch_dtype,
                          phase=phase)
    return x.to(cfg.torch_dtype)


def forward_hidden(params, batch, cfg: ModelConfig, *, phase="train"):
    """Teacher-forced forward up to the final norm -> hidden (B, S, D); each
    Mamba2 layer recomputed in the backward when ``cfg.remat`` and gradients
    are being taken (the reference checkpoints its scan body)."""
    x = _embed(params, batch["tokens"], cfg, phase)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    mask = nn.causal_mask(s, s, device=x.device)
    x = _stack(cfg, params, x, positions=positions, mask=mask, phase=phase)
    return nn.apply_rmsnorm(params["final_norm"], x)


def logits_head(params, hidden, cfg: ModelConfig, *, phase="train"):
    """Tied head: ``hidden @ E^T``."""
    return L.apply_logits(params["embed"], hidden, cfg=cfg.mpo, phase=phase)


def forward(params, batch, cfg: ModelConfig, *, phase="train"):
    """Teacher-forced forward -> logits (B, S, V)."""
    return logits_head(params, forward_hidden(params, batch, cfg, phase=phase), cfg,
                       phase=phase)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               paged: bool = False, device=None, **_) -> dict:
    """``{"kv": {k, v: (nseg, B, max_len, KV, Dh) in the config's dtype, pos:
    (nseg,) int32}, "ssm": (L, B, H, N, P) f32}``.  Each segment keeps one
    position for every row, so the cache has no per-slot sequence to page:
    ``paged=True`` raises, as the reference's ``init_cache`` does."""
    if paged:
        raise ValueError(f"paged KV cache is not supported for family {cfg.family!r}")
    dtype = dtype or cfg.torch_dtype
    nseg = num_segments(cfg)
    shape = (nseg, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"kv": {"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device),
                   "pos": torch.zeros((nseg,), dtype=torch.int32, device=device)},
            "ssm": mamba.init_ssm_state(cfg, batch, device=device)}


def reset_cache(cache: dict) -> dict:
    """Rewind a cache made by ``init_cache`` to zeros, in place."""
    for t in (cache["kv"]["k"], cache["kv"]["v"], cache["kv"]["pos"], cache["ssm"]):
        t.zero_()
    return cache


def prefill(params, batch, cache, cfg: ModelConfig, *, phase="prefill"):
    """The prompt from position 0: each segment's K/V and each layer's
    final SSM state written into ``cache`` in place (the incoming state's
    values are not read, as the reference's prefill ignores them).
    Returns (last-position logits (B, 1, V), cache)."""
    x = _embed(params, batch["tokens"], cfg, phase)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    mask = nn.causal_mask(s, cache["kv"]["k"].shape[2], device=x.device)
    x = _stack(cfg, params, x, positions=positions, mask=mask, cache=cache, phase=phase)
    x = nn.apply_rmsnorm(params["final_norm"], x)
    return logits_head(params, x[:, -1:], cfg, phase=phase), cache


def decode_step(params, tokens, cache, cfg: ModelConfig, *, phase="decode"):
    """One token for every row at segment 0's position (every segment holds
    the same one); the cache advances in place.  Returns (logits (B, 1, V),
    cache)."""
    x = _embed(params, tokens, cfg, phase)
    max_len = cache["kv"]["k"].shape[2]
    pos = cache["kv"]["pos"][0].clone()            # the segments advance the cache's
    positions = pos + torch.zeros((1, 1), dtype=pos.dtype, device=x.device)
    mask = (torch.arange(max_len, device=x.device)[None, :] <= pos)[None, None]
    x = _stack(cfg, params, x, positions=positions, mask=mask, cache=cache, decode=True,
               phase=phase)
    x = nn.apply_rmsnorm(params["final_norm"], x)
    return logits_head(params, x, cfg, phase=phase), cache
