"""Decoder-only transformer LM (and the encoder classifier), dense family —
the port of ``repro.models.transformer``.

The reference scans the stacked layer params with ``lax.scan``; here the
stack is a Python loop over the leading layer dim (``share_layers``
broadcasts the one stored layer).  ``cfg.remat`` recomputes each layer in
the backward (``torch.utils.checkpoint``, as the reference's
``jax.checkpoint`` of the scan body) when gradients are being taken.  The
MoE and VLM branches come with their families (ROADMAP.md, Queue 1 item 7).
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import layers as L
from repro_torch.models import nn


def attn_cfg(cfg: ModelConfig) -> nn.AttnCfg:
    return nn.AttnCfg(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
        attn_softcap=cfg.attn_softcap)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {"ln1": nn.init_rmsnorm(cfg.d_model),
            "ln2": nn.init_rmsnorm(cfg.d_model),
            "attn": nn.init_attention(gen, attn_cfg(cfg), cfg.mpo),
            "mlp": nn.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act, cfg.mpo)}


def _stack(trees: list) -> dict:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Parameters under the reference's key paths, the layer params stacked
    along a leading layer dim (one layer when ``share_layers``)."""
    if cfg.family != "dense" or cfg.num_experts:
        raise NotImplementedError(
            f"family {cfg.family!r} comes with ROADMAP.md, Queue 1 item 7")
    n_stored = 1 if cfg.share_layers else cfg.num_layers
    params = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, cfg=cfg.mpo),
        "layers": _stack([init_layer(gen, cfg) for _ in range(n_stored)]),
        "final_norm": nn.init_rmsnorm(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_linear(gen, cfg.d_model, cfg.vocab_size,
                                          cfg=cfg.mpo, kind="embed", sharded_out=True)
    if cfg.num_classes:
        params["cls_head"] = L.init_linear(gen, cfg.d_model, cfg.num_classes,
                                           cfg=L.DENSE)
    return params


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _layer_fwd(cfg: ModelConfig, x, layer, *, positions, mask, cache=None,
               phase="train"):
    h = nn.apply_rmsnorm(layer["ln1"], x)
    a, _ = nn.apply_attention(layer["attn"], h, attn_cfg(cfg), cfg.mpo,
                              positions=positions, mask=mask, cache=cache,
                              phase=phase)
    x = x + a
    h = nn.apply_rmsnorm(layer["ln2"], x)
    return x + nn.apply_mlp(layer["mlp"], h, cfg.mlp_act, cfg.mpo, phase=phase)


def _run_stack(cfg: ModelConfig, params, x, *, positions, mask, mask_local,
               caches=None, phase="train"):
    """The layer stack; ``caches`` (leading layer dim) is updated in place."""
    for i in range(cfg.num_layers):
        layer = _index(params["layers"], 0 if cfg.share_layers else i)
        # alternating local/global attention: even layers local
        m = mask_local if cfg.local_window is not None and i % 2 == 0 else mask
        cache = None if caches is None else _index(caches, i)
        if cfg.remat and cache is None and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                lambda x, layer, m: _layer_fwd(cfg, x, layer, positions=positions,
                                               mask=m, phase=phase),
                x, layer, m, use_reentrant=False)
        else:
            x = _layer_fwd(cfg, x, layer, positions=positions, mask=m, cache=cache,
                           phase=phase)
    return x


def _logits(cfg: ModelConfig, params, x, phase="train"):
    if cfg.tie_embeddings:
        logits = L.apply_logits(params["embed"], x, cfg=cfg.mpo, phase=phase)
    else:
        logits = L.apply_linear(params["lm_head"], x, cfg=cfg.mpo, phase=phase)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _embed_inputs(cfg: ModelConfig, params, tokens, phase="train"):
    """Token embeddings -> (B, S, D) in the config's dtype."""
    x = L.apply_embedding(params["embed"], tokens, cfg=cfg.mpo,
                          dtype=cfg.torch_dtype, phase=phase)
    if cfg.name.startswith("gemma"):
        x = x * (cfg.d_model ** 0.5)
    return x.to(cfg.torch_dtype)


def forward_hidden(params, batch, cfg: ModelConfig, *, phase="train"):
    """Teacher-forced forward up to the final norm -> hidden (B, S, D)."""
    x = _embed_inputs(cfg, params, batch["tokens"], phase)
    s, dev = x.shape[1], x.device
    positions = torch.arange(s, device=dev)[None, :]
    if cfg.causal:
        mask = nn.causal_mask(s, s, device=dev)
    else:  # encoder (BERT/ALBERT analog): full bidirectional attention
        mask = torch.ones((1, 1, s, s), dtype=torch.bool, device=dev)
    mask_local = nn.causal_mask(s, s, window=cfg.local_window, device=dev)
    x = _run_stack(cfg, params, x, positions=positions, mask=mask,
                   mask_local=mask_local, phase=phase)
    return nn.apply_rmsnorm(params["final_norm"], x)


def logits_head(params, hidden, cfg: ModelConfig, *, phase="train"):
    return _logits(cfg, params, hidden, phase)


def forward(params, batch, cfg: ModelConfig, *, phase="train"):
    """Teacher-forced forward -> logits (B, S, V)."""
    return _logits(cfg, params, forward_hidden(params, batch, cfg, phase=phase), phase)


def forward_cls(params, batch, cfg: ModelConfig):
    """Sequence classification (paper's GLUE-analog): the first token's
    final hidden state through the dense ``cls_head`` -> logits (B, C)."""
    x = forward_hidden(params, batch, cfg, phase="train")
    return L.apply_linear(params["cls_head"], x[:, 0], cfg=L.DENSE)


# --------------------------------------------------------------------------
# serving (prefill / decode with per-layer KV caches)
# --------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               paged: bool = False, page_size: int = 16, device=None) -> dict:
    """KV cache with PER-SLOT positions: ``pos`` is (layers, batch).

    ``paged=True`` keeps K/V in a pool of ``batch * max_len / page_size``
    fixed-size pages; each slot maps logical pages to physical ones through
    its ``page_table`` row (-1 = unmapped), and pages are popped off the
    ``free_list`` stack as a slot's context grows.  Every leaf keeps the
    leading layer dim."""
    dtype = dtype or cfg.torch_dtype
    acfg = attn_cfg(cfg)
    nl = cfg.num_layers
    if not paged:
        shape = (nl, batch, max_len, acfg.num_kv_heads, acfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "pos": torch.zeros((nl, batch), dtype=torch.int32, device=device)}
    if page_size <= 0:
        raise ValueError(f"page_size must be positive, got {page_size}")
    if max_len % page_size != 0:
        raise ValueError(
            f"page_size={page_size} does not divide max_len={max_len}: the "
            f"tail page would be only partially usable. Use a page_size that "
            f"divides max_len (e.g. {math.gcd(max_len, page_size)}) or round "
            f"max_len up to {page_size * (-(-max_len // page_size))}.")
    mp = max_len // page_size                     # logical pages per slot
    pool = batch * mp
    pshape = (nl, pool, page_size, acfg.num_kv_heads, acfg.head_dim)
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "k_pages": torch.zeros(pshape, dtype=dtype, device=device),
        "v_pages": torch.zeros(pshape, dtype=dtype, device=device),
        "page_table": torch.full((nl, batch, mp), -1, **i32),
        "pos": torch.zeros((nl, batch), **i32),
        "free_list": torch.arange(pool, **i32).repeat(nl, 1),
        "free_count": torch.full((nl,), pool, **i32),
    }


def cache_kv_len(cache) -> int:
    """Key span the decode masks cover: ``max_len`` for dense caches, page
    capacity (``MP * page_size``) for paged ones."""
    if "k_pages" in cache:
        return cache["page_table"].shape[-1] * cache["k_pages"].shape[2]
    return cache["k"].shape[2]


def prefill(params, batch, cache, cfg: ModelConfig, *, phase="prefill"):
    """Fill the KV caches (in place) with the prompt; returns
    (last-position logits (B, 1, V), cache)."""
    x = _embed_inputs(cfg, params, batch["tokens"], phase)
    s, dev = x.shape[1], x.device
    max_len = cache_kv_len(cache)
    positions = torch.arange(s, device=dev)[None, :]
    mask = nn.causal_mask(s, max_len, device=dev)
    mask_local = nn.causal_mask(s, max_len, window=cfg.local_window, device=dev)
    x = _run_stack(cfg, params, x, positions=positions, mask=mask,
                   mask_local=mask_local, caches=cache, phase=phase)
    x = nn.apply_rmsnorm(params["final_norm"], x)
    return _logits(cfg, params, x[:, -1:], phase), cache


def decode_step(params, tokens, cache, cfg: ModelConfig, *, phase="decode"):
    """One-token decode against a filled cache (updated in place).
    tokens: (B, 1).  Each slot applies RoPE at its own position and masks
    keys beyond it."""
    x = _embed_inputs(cfg, params, tokens, phase)
    max_len = cache_kv_len(cache)
    pos = cache["pos"][0].clone()                  # the layers advance the cache's
    positions = pos[:, None]                       # (B, 1) for rope
    kj = torch.arange(max_len, device=x.device)[None, :]
    mask = (kj <= pos[:, None])[:, None, None, :]  # (B, 1, 1, S)
    if cfg.local_window is not None:
        mask_local = mask & (kj > pos[:, None] - cfg.local_window)[:, None, None, :]
    else:
        mask_local = mask
    x = _run_stack(cfg, params, x, positions=positions, mask=mask,
                   mask_local=mask_local, caches=cache, phase=phase)
    x = nn.apply_rmsnorm(params["final_norm"], x)
    return _logits(cfg, params, x, phase), cache
