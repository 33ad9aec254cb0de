"""Whisper-style encoder-decoder — the port of ``repro.models.whisper``.

The audio frontend is a stub, as in the reference: ``batch["frames"]``
holds precomputed frame embeddings (B, frontend_len, d_model).  The encoder
adds learned positions and runs bidirectional pre-LN blocks; the decoder
adds learned positions to the tied token embedding and runs pre-LN blocks
of causal self-attention, cross-attention over the encoder's output and a
plain-GELU MLP; the head is the tied embedding's transpose.  No attention
uses rope.

The serving cache is ``{"self": {"k", "v": (L, B, max_len, KV, Dh), "pos":
(L,) int32}, "enc_out": (B, frontend_len, d_model)}``, written in place:
each decoder layer keeps one position for every row (a 0-d ``pos``, as the
hybrid family's segments).  It is not paged (``paged=True`` raises, as the
reference's ``init_cache`` does), and there is no incremental prefill.  A
decode step recomputes the cross-attention K/V from ``enc_out`` in every
layer, as the reference does.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import layers as L
from repro_torch.core.mpo import randn
from repro_torch.models import nn
from repro_torch.parallel import spmd


def _acfg(cfg: ModelConfig, causal: bool) -> nn.AttnCfg:
    return nn.AttnCfg(d_model=cfg.d_model, num_heads=cfg.num_heads,
                      num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                      use_rope=False, causal=causal)


def init_enc_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {"ln1": nn.init_layernorm(cfg.d_model),
            "attn": nn.init_attention(gen, _acfg(cfg, False), cfg.mpo),
            "ln2": nn.init_layernorm(cfg.d_model),
            "mlp": nn.init_mlp(gen, cfg.d_model, cfg.d_ff, "gelu_plain", cfg.mpo)}


def init_dec_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {"ln1": nn.init_layernorm(cfg.d_model),
            "attn": nn.init_attention(gen, _acfg(cfg, True), cfg.mpo),
            "ln_x": nn.init_layernorm(cfg.d_model),
            "xattn": nn.init_attention(gen, _acfg(cfg, False), cfg.mpo),
            "ln2": nn.init_layernorm(cfg.d_model),
            "mlp": nn.init_mlp(gen, cfg.d_model, cfg.d_ff, "gelu_plain", cfg.mpo)}


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The reference's tree: ``embed``, ``enc_pos`` (frontend_len, d),
    ``dec_pos`` (max_pos, d), ``encoder`` and ``decoder`` (stacked),
    ``enc_norm`` and ``final_norm``."""
    return {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, cfg=cfg.mpo),
        "enc_pos": L.annot(0.02 * randn((cfg.frontend_len, cfg.d_model), gen),
                           (None, "embed")),
        "dec_pos": L.annot(0.02 * randn((cfg.max_pos, cfg.d_model), gen),
                           (None, "embed")),
        "encoder": nn.stack_layers(lambda g: init_enc_layer(g, cfg), gen, cfg.num_enc_layers),
        "decoder": nn.stack_layers(lambda g: init_dec_layer(g, cfg), gen, cfg.num_layers),
        "enc_norm": nn.init_layernorm(cfg.d_model),
        "final_norm": nn.init_layernorm(cfg.d_model),
    }


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, recomputed in the backward when ``cfg.remat`` and
    gradients are being taken (the reference checkpoints its scan body)."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def encode(params, frames, cfg: ModelConfig, *, phase="train"):
    """frames (B, F, D) stub embeddings -> the encoder's output (B, F, D)."""
    dt = cfg.torch_dtype
    x = frames.to(dt) + params["enc_pos"][None].to(dt)
    sf = x.shape[1]
    mask = torch.ones((1, 1, sf, sf), dtype=torch.bool, device=x.device)
    positions = torch.arange(sf, device=x.device)[None, :]

    def body(x, layer):
        h = nn.apply_layernorm(layer["ln1"], x)
        a, _ = nn.apply_attention(layer["attn"], h, _acfg(cfg, False), cfg.mpo,
                                  positions=positions, mask=mask, phase=phase)
        x = x + a
        h = nn.apply_layernorm(layer["ln2"], x)
        return x + nn.apply_mlp(layer["mlp"], h, "gelu_plain", cfg.mpo, phase=phase)

    for i in range(cfg.num_enc_layers):
        x = _remat(cfg, body, x, nn.index_layer(params["encoder"], i))
    return nn.apply_layernorm(params["enc_norm"], x)


def _dec_stack(cfg: ModelConfig, params, x, enc_out, *, positions, mask, cache=None,
               phase="train"):
    """The decoder's layers; with ``cache`` (the ``self`` part of the
    serving cache) each layer's K/V and position are written in place."""
    xmask = torch.ones((1, 1, x.shape[1], enc_out.shape[1]), dtype=torch.bool,
                       device=x.device)

    def body(x, layer, self_cache=None):
        h = nn.apply_layernorm(layer["ln1"], x)
        a, _ = nn.apply_attention(layer["attn"], h, _acfg(cfg, True), cfg.mpo,
                                  positions=positions, mask=mask, cache=self_cache,
                                  phase=phase)
        x = x + a
        h = nn.apply_layernorm(layer["ln_x"], x)
        a, _ = nn.apply_attention(layer["xattn"], h, _acfg(cfg, False), cfg.mpo,
                                  positions=positions, mask=xmask, kv_x=enc_out, phase=phase)
        x = x + a
        h = nn.apply_layernorm(layer["ln2"], x)
        return x + nn.apply_mlp(layer["mlp"], h, "gelu_plain", cfg.mpo, phase=phase)

    for i in range(cfg.num_layers):
        layer = nn.index_layer(params["decoder"], i)
        if cache is None:
            x = _remat(cfg, body, x, layer)
        else:
            x = body(x, layer, nn.index_layer(cache, i))
    return x


def _embed(params, tokens, cfg: ModelConfig, phase: str):
    x = L.apply_embedding(params["embed"], tokens, cfg=cfg.mpo, dtype=cfg.torch_dtype,
                          phase=phase)
    return x.to(cfg.torch_dtype)


def forward_hidden(params, batch, cfg: ModelConfig, *, phase="train"):
    """``{frames: (B, F, D), tokens: (B, S)}`` -> the decoder's hidden
    state after the final norm (B, S, D)."""
    enc_out = encode(params, batch["frames"], cfg, phase=phase)
    x = _embed(params, batch["tokens"], cfg, phase)
    s = x.shape[1]
    x = x + params["dec_pos"][:s][None].to(x.dtype)
    positions = torch.arange(s, device=x.device)[None, :]
    mask = nn.causal_mask(s, s, device=x.device)
    x = _dec_stack(cfg, params, x, enc_out, positions=positions, mask=mask, phase=phase)
    return nn.apply_layernorm(params["final_norm"], x)


def logits_head(params, hidden, cfg: ModelConfig, *, phase="train"):
    """Tied head: ``hidden @ E^T``, over the embedding cores' padded rows
    (the reference's width)."""
    return L.apply_logits(params["embed"], hidden, cfg=cfg.mpo, phase=phase)


def forward(params, batch, cfg: ModelConfig, *, phase="train"):
    """Teacher-forced forward -> logits (B, S, V)."""
    return logits_head(params, forward_hidden(params, batch, cfg, phase=phase), cfg,
                       phase=phase)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               paged: bool = False, device=None, **_) -> dict:
    """``{"self": {k, v: (L, B, max_len, KV, Dh), pos: (L,) int32},
    "enc_out": (B, frontend_len, d_model)}`` in the config's dtype.  Each
    layer keeps one position for every row, so the cache has no per-slot
    sequence to page: ``paged=True`` raises, as the reference's
    ``init_cache`` does."""
    if paged:
        raise ValueError(f"paged KV cache is not supported for family {cfg.family!r}")
    dtype = dtype or cfg.torch_dtype
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"self": {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device),
                     "pos": torch.zeros((cfg.num_layers,), dtype=torch.int32, device=device)},
            "enc_out": torch.zeros((batch, cfg.frontend_len, cfg.d_model), dtype=dtype,
                                   device=device)}


def reset_cache(cache: dict) -> dict:
    """Rewind a cache made by ``init_cache`` to zeros, in place."""
    for t in (cache["self"]["k"], cache["self"]["v"], cache["self"]["pos"],
              cache["enc_out"]):
        t.zero_()
    return cache


def prefill(params, batch, cache, cfg: ModelConfig, *, phase="prefill"):
    """Encode ``batch["frames"]`` and run the prompt ``batch["tokens"]``:
    each decoder layer's K/V written at its position, and the encoder's
    output stored in the cache's dtype, in place.  Returns (last-position
    logits (B, 1, V), cache)."""
    enc_out = encode(params, batch["frames"], cfg, phase=phase)
    x = _embed(params, batch["tokens"], cfg, phase)
    s = x.shape[1]
    x = x + params["dec_pos"][:s][None].to(x.dtype)
    positions = torch.arange(s, device=x.device)[None, :]
    mask = nn.causal_mask(s, cache["self"]["k"].shape[2], device=x.device)
    x = _dec_stack(cfg, params, x, enc_out, positions=positions, mask=mask,
                   cache=cache["self"], phase=phase)
    x = nn.apply_layernorm(params["final_norm"], x)
    spmd.write_block(cache["enc_out"], enc_out)
    return logits_head(params, x[:, -1:], cfg, phase=phase), cache


def decode_step(params, tokens, cache, cfg: ModelConfig, *, phase="decode"):
    """One token for every row at layer 0's position; the cross-attention
    K/V recomputed from the stored encoder output; the cache advances in
    place.  The position row of ``dec_pos`` is clamped into the table, as
    the reference's ``dynamic_slice_in_dim`` clamps it.  Returns (logits
    (B, 1, V), cache)."""
    enc = cache["enc_out"]                         # on a mesh: its rows over `data`
    enc_out = spmd.gather_batch(spmd.local(enc), 0, enc).to(cfg.torch_dtype)
    max_len = cache["self"]["k"].shape[2]
    pos = cache["self"]["pos"][0].clone()          # the layers advance the cache's
    x = _embed(params, tokens, cfg, phase)
    table = params["dec_pos"]
    row = pos.clamp(0, table.shape[0] - 1).reshape(1).long()
    x = x + table.index_select(0, row)[None].to(x.dtype)
    positions = pos + torch.zeros((1, 1), dtype=pos.dtype, device=x.device)
    mask = (torch.arange(max_len, device=x.device)[None, :] <= pos)[None, None]
    x = _dec_stack(cfg, params, x, enc_out, positions=positions, mask=mask,
                   cache=cache["self"], phase=phase)
    x = nn.apply_layernorm(params["final_norm"], x)
    return logits_head(params, x, cfg, phase=phase), cache
