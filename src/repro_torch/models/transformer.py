"""Decoder-only transformer LM (and the encoder classifier) — the port of
``repro.models.transformer``, for the dense, MoE and VLM families.

The reference scans the stacked layer params with ``lax.scan``; here the
stack is a Python loop over the leading layer dim (``share_layers``
broadcasts the one stored layer).  ``cfg.remat`` recomputes each layer in
the backward (``torch.utils.checkpoint``, as the reference's
``jax.checkpoint`` of the scan body) when gradients are being taken.  MoE
layers (``cfg.num_experts``) replace the MLP with ``models.moe`` and sum
its load-balance loss over the layers; VLM configs put the projected patch
embeddings (``batch["patches"]``, the modality frontend itself a stub, as
in the reference) ahead of the text.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import layers as L
from repro_torch.models import nn
from repro_torch.models.moe import apply_moe, init_moe


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
    p = {"ln1": nn.init_rmsnorm(cfg.d_model),
         "ln2": nn.init_rmsnorm(cfg.d_model),
         "attn": nn.init_attention(gen, attn_cfg(cfg), cfg.mpo)}
    if cfg.num_experts:
        p["moe"] = init_moe(gen, cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.mlp_act, cfg.mpo)
    else:
        p["mlp"] = nn.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act, cfg.mpo)
    return p


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Parameters under the reference's key paths, the layer params stacked
    along a leading layer dim (one layer when ``share_layers``); a VLM's
    dense f32 ``projector`` (``frontend_dim -> d_model``)."""
    n_stored = 1 if cfg.share_layers else cfg.num_layers
    params = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, cfg=cfg.mpo),
        "layers": nn.stack_layers(lambda g: init_layer(g, cfg), gen, n_stored),
        "final_norm": nn.init_rmsnorm(cfg.d_model),
    }
    if cfg.family == "vlm":
        params["projector"] = L.init_linear(gen, cfg.frontend_dim, cfg.d_model, cfg=L.DENSE)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_linear(gen, cfg.d_model, cfg.vocab_size,
                                          cfg=cfg.mpo, kind="embed", out_axis="vocab",
                                          sharded_out=True)
    if cfg.num_classes:
        params["cls_head"] = L.init_linear(gen, cfg.d_model, cfg.num_classes,
                                           cfg=L.DENSE)
    return params


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _layer_fwd(cfg: ModelConfig, x, layer, *, positions, mask, cache=None,
               phase="train", chunk=False):
    """One layer -> (x, its MoE load-balance loss: 0 without experts)."""
    h = nn.apply_rmsnorm(layer["ln1"], x)
    a, _ = nn.apply_attention(layer["attn"], h, attn_cfg(cfg), cfg.mpo,
                              positions=positions, mask=mask, cache=cache,
                              phase=phase, chunk=chunk)
    x = x + a
    h = nn.apply_rmsnorm(layer["ln2"], x)
    if cfg.num_experts:
        f, aux = apply_moe(layer["moe"], h, act=cfg.mlp_act, mpo=cfg.mpo, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor, phase=phase)
        return x + f, aux
    return x + nn.apply_mlp(layer["mlp"], h, cfg.mlp_act, cfg.mpo, phase=phase), 0.0


def _run_stack(cfg: ModelConfig, params, x, *, positions, mask, mask_local,
               caches=None, phase="train", chunk=False):
    """The layer stack -> (x, the load-balance loss summed over the layers,
    f32); ``caches`` (leading layer dim) is updated in place."""
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        layer = nn.index_layer(params["layers"], 0 if cfg.share_layers else i)
        # alternating local/global attention: even layers local
        m = mask_local if cfg.local_window is not None and i % 2 == 0 else mask
        cache = None if caches is None else nn.index_layer(caches, i)
        if cfg.remat and cache is None and torch.is_grad_enabled():
            x, aux = torch.utils.checkpoint.checkpoint(
                lambda x, layer, m: _layer_fwd(cfg, x, layer, positions=positions,
                                               mask=m, phase=phase),
                x, layer, m, use_reentrant=False)
        else:
            x, aux = _layer_fwd(cfg, x, layer, positions=positions, mask=m, cache=cache,
                                phase=phase, chunk=chunk)
        aux_sum = aux_sum + aux
    return x, aux_sum


def _logits(cfg: ModelConfig, params, x, phase="train"):
    if cfg.tie_embeddings:
        logits = L.apply_logits(params["embed"], x, cfg=cfg.mpo, phase=phase)
    else:
        logits = L.apply_linear(params["lm_head"], x, cfg=cfg.mpo, phase=phase)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _embed_inputs(cfg: ModelConfig, params, batch: dict, phase="train"):
    """Token embeddings (B, S, D) in the config's dtype; a VLM batch's
    ``patches`` (B, P, frontend_dim) projected in f32 and put ahead of the
    text -> (B, P + S, D)."""
    x = L.apply_embedding(params["embed"], batch["tokens"], cfg=cfg.mpo,
                          dtype=cfg.torch_dtype, phase=phase)
    if cfg.name.startswith("gemma"):
        x = x * (cfg.d_model ** 0.5)
    if cfg.family == "vlm" and "patches" in batch:
        p = batch["patches"].float() @ params["projector"]["w"].float()
        x = torch.cat([p.to(x.dtype), x], dim=1)
    return x.to(cfg.torch_dtype)


def forward_hidden(params, batch, cfg: ModelConfig, *, phase="train", with_aux=False):
    """Teacher-forced forward up to the final norm -> hidden (B, S, D), or
    ``(hidden, aux)`` with the MoE load-balance loss summed over the layers
    (0 without experts) when ``with_aux``."""
    x = _embed_inputs(cfg, params, batch, phase)
    s, dev = x.shape[1], x.device
    positions = torch.arange(s, device=dev)[None, :]
    if cfg.causal:
        mask = nn.causal_mask(s, s, device=dev)
    else:  # encoder (BERT/ALBERT analog): full bidirectional attention
        mask = torch.ones((1, 1, s, s), dtype=torch.bool, device=dev)
    mask_local = nn.causal_mask(s, s, window=cfg.local_window, device=dev)
    x, aux = _run_stack(cfg, params, x, positions=positions, mask=mask,
                        mask_local=mask_local, phase=phase)
    hidden = nn.apply_rmsnorm(params["final_norm"], x)
    return (hidden, aux) if with_aux else hidden


def logits_head(params, hidden, cfg: ModelConfig, *, phase="train"):
    return _logits(cfg, params, hidden, phase)


def forward(params, batch, cfg: ModelConfig, *, phase="train", with_aux=False):
    """Teacher-forced forward -> logits (B, S, V), or ``(logits, aux)`` when
    ``with_aux`` (the reference's return)."""
    hidden, aux = forward_hidden(params, batch, cfg, phase=phase, with_aux=True)
    logits = _logits(cfg, params, hidden, phase)
    return (logits, aux) if with_aux else logits


def forward_cls(params, batch, cfg: ModelConfig):
    """Sequence classification (paper's GLUE-analog): the first token's
    final hidden state through the dense ``cls_head`` -> logits (B, C)."""
    x = forward_hidden(params, batch, cfg, phase="train")
    return L.apply_linear(params["cls_head"], x[:, 0], cfg=L.DENSE)


# --------------------------------------------------------------------------
# serving (prefill / decode with per-layer KV caches)
# --------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               paged: bool = False, page_size: int = 16, pool_pages: int | None = None,
               device=None) -> dict:
    """KV cache with PER-SLOT positions: ``pos`` is (layers, batch), so each
    slot of a ``pipeline.scheduler.ServePool`` sits at its own offset.

    ``paged=True`` keeps K/V in a pool of fixed-size pages, by default
    ``batch * max_len / page_size`` of them (every slot full), so allocation
    never exhausts it; each slot maps logical pages to physical ones through
    its ``page_table`` row (-1 = unmapped), and pages are popped off the
    ``free_list`` stack as a slot's context grows.  ``pool_pages`` smaller
    oversubscribes the pool; ``ServePool``'s page-reservation admission then
    keeps the free list from underflowing.  Every leaf keeps the leading
    layer dim."""
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
    pool = batch * mp if pool_pages is None else int(pool_pages)
    if not 1 <= pool <= batch * mp:
        raise ValueError(
            f"pool_pages={pool_pages} out of range [1, {batch * mp}] "
            f"(batch={batch} slots x {mp} pages each); oversubscribe by "
            f"passing fewer pages than batch*max_pages, never more")
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


def reset_cache(cache: dict) -> dict:
    """Rewind a cache made by ``init_cache`` to its initial contents, in
    place: zero K/V and positions and, when paged, every page back on the
    free list with an unmapped page table."""
    for name in ("k", "v", "k_pages", "v_pages", "pos"):
        if name in cache:
            cache[name].zero_()
    if "page_table" in cache:
        free = cache["free_list"]
        cache["page_table"].fill_(-1)
        free.copy_(torch.arange(free.shape[-1], dtype=free.dtype, device=free.device)
                   .expand_as(free))
        cache["free_count"].fill_(free.shape[-1])
    return cache


def cache_kv_len(cache) -> int:
    """Key span the decode masks cover: ``max_len`` for dense caches, page
    capacity (``MP * page_size``) for paged ones."""
    if "k_pages" in cache:
        return cache["page_table"].shape[-1] * cache["k_pages"].shape[2]
    return cache["k"].shape[2]


def prefill(params, batch, cache, cfg: ModelConfig, *, phase="prefill"):
    """Fill the KV caches (in place) with the prompt; returns
    (last-position logits (B, 1, V), cache)."""
    x = _embed_inputs(cfg, params, batch, phase)
    s, dev = x.shape[1], x.device
    max_len = cache_kv_len(cache)
    positions = torch.arange(s, device=dev)[None, :]
    mask = nn.causal_mask(s, max_len, device=dev)
    mask_local = nn.causal_mask(s, max_len, window=cfg.local_window, device=dev)
    x, _ = _run_stack(cfg, params, x, positions=positions, mask=mask,
                      mask_local=mask_local, caches=cache, phase=phase)
    x = nn.apply_rmsnorm(params["final_norm"], x)
    return _logits(cfg, params, x[:, -1:], phase), cache


def prefill_chunk(params, batch, cache, cfg: ModelConfig, *, phase="prefill"):
    """One CHUNK of an incremental prefill: ``s`` prompt tokens at each
    slot's CURRENT cache offset (``cache["pos"]``), their K/V appended in
    place.  Chunk ``c``'s queries apply RoPE at their global offsets and
    attend every key at or before them (earlier chunks included), so the
    chunks in turn give one whole ``prefill``'s tokens.

    Returns ``(logits (B, s, V), cache)`` — ALL chunk positions: the caller
    takes the real last prompt token's row (under length-bucketed padding
    generally not the last row).  Rows must share one offset (admission is
    batch 1; the dense write starts at row 0's position)."""
    x = _embed_inputs(cfg, params, batch, phase)
    s, dev = x.shape[1], x.device
    max_len = cache_kv_len(cache)
    start = cache["pos"][0].clone()                # the layers advance the cache's
    positions = start[:, None] + torch.arange(s, device=dev)[None, :]   # (B, s)
    kj = torch.arange(max_len, device=dev)[None, None, :]
    qi = positions[:, :, None]                     # (B, s, 1)
    mask = (kj <= qi)[:, None]                     # (B, 1, s, max_len)
    if cfg.local_window is not None:
        mask_local = mask & (kj > qi - cfg.local_window)[:, None]
    else:
        mask_local = mask
    x, _ = _run_stack(cfg, params, x, positions=positions, mask=mask,
                      mask_local=mask_local, caches=cache, phase=phase, chunk=True)
    x = nn.apply_rmsnorm(params["final_norm"], x)
    return _logits(cfg, params, x, phase), cache


def decode_step(params, tokens, cache, cfg: ModelConfig, *, phase="decode"):
    """One-token decode against a filled cache (updated in place).
    tokens: (B, 1).  Each slot applies RoPE at its own position and masks
    keys beyond it."""
    x = _embed_inputs(cfg, params, {"tokens": tokens}, phase)
    max_len = cache_kv_len(cache)
    pos = cache["pos"][0].clone()                  # the layers advance the cache's
    positions = pos[:, None]                       # (B, 1) for rope
    kj = torch.arange(max_len, device=x.device)[None, :]
    mask = (kj <= pos[:, None])[:, None, None, :]  # (B, 1, 1, S)
    if cfg.local_window is not None:
        mask_local = mask & (kj > pos[:, None] - cfg.local_window)[:, None, None, :]
    else:
        mask_local = mask
    x, _ = _run_stack(cfg, params, x, positions=positions, mask=mask,
                      mask_local=mask_local, caches=cache, phase=phase)
    x = nn.apply_rmsnorm(params["final_norm"], x)
    return _logits(cfg, params, x, phase), cache
