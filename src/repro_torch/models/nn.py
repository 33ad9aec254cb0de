"""Shared neural building blocks — the port of ``repro.models.nn``.

Init functions return nested dicts of tensors drawn from a
``torch.Generator`` (on its device: the CPU's unless the caller draws on the
card); apply functions are plain functions on tensors.

The KV caches are updated IN PLACE (the reference returns new arrays): a
cache is a dict of tensors, and each append writes its K/V rows, page-table
entries, free count and positions into them, which saves a copy of the whole
cache per layer per step.  Where the reference relies on JAX clamping an
out-of-range gather or dropping an out-of-range scatter write, the port
clamps and masks explicitly (``_take``, ``_scatter_rows``) and gets the
same result.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import layers as L
from repro_torch.core.layers import MPOConfig
from repro_torch.kernels import decode_attention as DA
from repro_torch.parallel import spmd

# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def init_rmsnorm(dim: int, axis: str | None = "embed") -> dict:
    return {"scale": L.annot(torch.ones(dim), (axis,))}


def apply_rmsnorm(params, x, eps: float = 1e-6):
    # variance in f32, normalize/scale in the compute dtype (as the reference)
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


def init_layernorm(dim: int) -> dict:
    return {"scale": L.annot(torch.ones(dim), ("embed",)),
            "bias": L.annot(torch.zeros(dim), ("embed",))}


def apply_layernorm(params, x, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return ((x - mu.to(x.dtype)) * inv * params["scale"].to(x.dtype)
            + params["bias"].to(x.dtype))


# --------------------------------------------------------------------------
# stacked layers
# --------------------------------------------------------------------------


def _stack(trees: list, axis: str | None):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], axis) for k in trees[0]}
    if isinstance(trees[0], L.Annot):
        return L.Annot(torch.stack([t.value for t in trees]), (axis,) + trees[0].axes)
    return torch.stack(trees)


def stack_layers(init_fn, gen: torch.Generator, n_layers: int,
                 axis: str | None = "layers") -> dict:
    """``n_layers`` draws of ``init_fn(gen)`` stacked along a leading dim
    named ``axis``, as the reference's scan-stacked params."""
    return _stack([init_fn(gen) for _ in range(n_layers)], axis)


def index_layer(tree, i: int):
    """Layer ``i`` of a stacked tree (params or a cache): views, no copy."""
    if isinstance(tree, dict):
        return {k: index_layer(v, i) for k, v in tree.items()}
    return tree[i]


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S).  f32 inside,
    cast back to x's dtype."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq               # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention (GQA + softcap + qk-norm)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_softcap: float | None = None
    causal: bool = True
    use_rope: bool = True


def init_attention(gen: torch.Generator, cfg: AttnCfg, mpo: MPOConfig) -> dict:
    d, h, kvh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    # a projection is tensor-parallel only if its HEAD count divides the
    # shard multiple; that choice sets the factorization, so it is kept
    q_ok = mpo.shard_multiple <= 1 or h % mpo.shard_multiple == 0
    kv_ok = mpo.shard_multiple <= 1 or kvh % mpo.shard_multiple == 0
    p = {
        "wq": L.init_linear(gen, d, h * dh, cfg=mpo, kind="attn", out_axis="qkv",
                            sharded_out=q_ok),
        "wk": L.init_linear(gen, d, kvh * dh, cfg=mpo, kind="attn", out_axis="kv_qkv",
                            sharded_out=kv_ok),
        "wv": L.init_linear(gen, d, kvh * dh, cfg=mpo, kind="attn", out_axis="kv_qkv",
                            sharded_out=kv_ok),
        "wo": L.init_linear(gen, h * dh, d, cfg=mpo, kind="attn", in_axis="qkv",
                            sharded_in=q_ok, scale=(h * dh) ** -0.5),
    }
    if cfg.qk_norm:
        # head_dim-sized scales are not an embed dim: no FSDP axis
        p["q_norm"] = init_rmsnorm(dh, axis=None)
        p["k_norm"] = init_rmsnorm(dh, axis=None)
    return p


def _split_heads(x, n, dh):
    return x.reshape(x.shape[:-1] + (n, dh))


def attention_scores(q, k, cfg: AttnCfg, mask):
    """Grouped-query softmax weights without repeating K.

    q: (B,Sq,H,Dh), k: (B,Sk,KV,Dh) -> (B,KV,G,Sq,Sk) f32 (H = KV*G)."""
    b, sq, h, dh = q.shape
    g = h // cfg.num_kv_heads
    qg = q.reshape(b, sq, cfg.num_kv_heads, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(cfg.head_dim)
    if cfg.attn_softcap:
        c = cfg.attn_softcap
        scores = c * torch.tanh(scores / c)
    scores = torch.where(mask[:, :, None], scores, DA.MASK_VALUE)
    return torch.softmax(scores.float(), dim=-1)


def causal_mask(sq: int, sk: int, *, window: int | None = None, offset: int = 0,
                device=None) -> torch.Tensor:
    """(1,1,Sq,Sk) boolean; query i attends key j iff j <= i+offset (and
    i+offset-j < window for local attention)."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(sk, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m = m & (qi - kj < window)
    return m[None, None]


# --------------------------------------------------------------------------
# cache updates with the reference's out-of-range semantics
# --------------------------------------------------------------------------


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[idx]`` as JAX gathers: a negative index wraps once, and what is
    still out of range is clamped to the nearest end."""
    n = arr.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return arr[idx]


def _scatter_rows(flat: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
                  keep: torch.Tensor) -> None:
    """``flat[rows[i]] = vals[i]`` where ``keep[i]``; the other writes are
    dropped, as JAX drops an out-of-range scatter write.

    Without a host sync: a dropped write goes to row 0 with the value row 0
    holds after the kept writes, so every write to row 0 agrees and the
    result does not depend on their order."""
    vals = vals.to(flat.dtype)
    rows = torch.where(keep, rows, torch.zeros_like(rows))
    hit = keep & (rows == 0)
    first = vals.index_select(0, hit.int().argmax().reshape(1))[0]   # no host sync
    final0 = torch.where(hit.any(), first, flat[0])
    vals = torch.where(keep.view(-1, *[1] * (vals.dim() - 1)), vals, final0)
    flat.index_put_((rows,), vals)


def _pages(cache):
    """(k pages, v pages, page size, first in-page offset) this rank writes:
    the whole pool, or on a mesh its block (``spmd.local``) — in-page
    positions [o0, o0 + its page size) of every page, the kv heads its K/V
    slices carry."""
    kp, vp = cache["k_pages"], cache["v_pages"]
    return spmd.local(kp), spmd.local(vp), kp.shape[1], spmd.local_range(kp, 1)[0]


def _paged_prefill_append(cache, k, v):
    """Write a start-0 prompt's K/V into freshly allocated pages, in place.

    Prefill always begins at position 0, so allocation pops ``ceil(s / ps)``
    pages per slot off the free-list stack."""
    b, s = k.shape[0], k.shape[1]
    kp, vp, ps, o0 = _pages(cache)
    npg = -(-s // ps)                              # pages per slot
    pad = npg * ps - s
    kq = F.pad(k, (0, 0, 0, 0, 0, pad)).to(kp.dtype)
    vq = F.pad(v, (0, 0, 0, 0, 0, pad)).to(vp.dtype)
    rank = torch.arange(b * npg, device=k.device)
    pids = _take(cache["free_list"], cache["free_count"] - 1 - rank).reshape(b, npg)
    lps = kp.shape[1]
    kp[pids.reshape(-1).long()] = kq.reshape(b * npg, ps, *k.shape[2:])[:, o0:o0 + lps]
    vp[pids.reshape(-1).long()] = vq.reshape(b * npg, ps, *v.shape[2:])[:, o0:o0 + lps]
    cache["page_table"][:, :npg] = pids
    cache["free_count"].sub_(b * npg)
    cache["pos"].add_(s)
    return cache


def _paged_chunk_append(cache, k, v):
    """Append an ``s``-token prefill CHUNK at each slot's current position,
    in place, allocating pages for every page boundary the chunk crosses.

    The general form of ``_paged_prefill_append`` (start 0, whole prompt)
    and ``_paged_decode_append`` (one token): chunk ``c`` of a chunked
    admission starts at ``pos = c * chunk_len``, the first page it touches
    possibly half filled by the previous chunk.  Positions past capacity
    neither allocate nor write, as in the decode append."""
    b, s = k.shape[0], k.shape[1]
    kp, vp, ps, o0 = _pages(cache)
    table = cache["page_table"]
    pos = cache["pos"]                             # (B,)
    p_total, lps = kp.shape[0], kp.shape[1]
    mp = table.shape[1]
    # map every logical page the chunk touches that has no physical page yet
    pages = torch.arange(mp, device=k.device)[None, :]
    lo = pos[:, None] // ps
    hi = torch.clamp((pos[:, None] + s - 1) // ps, max=mp - 1)
    need = (pages >= lo) & (pages <= hi) & (table < 0)    # (B, MP)
    flat = need.reshape(-1)
    rank = torch.cumsum(flat.int(), 0) - 1
    fresh = _take(cache["free_list"], cache["free_count"] - 1 - rank).reshape(b, mp)
    table.copy_(torch.where(need, fresh, table))
    # scatter the chunk's rows at their global positions
    g = pos[:, None] + torch.arange(s, device=k.device)[None, :]   # (B, s)
    oob = g >= mp * ps
    lp = torch.clamp(g // ps, max=mp - 1).long()
    off = g % ps - o0                              # offset within the rank's block
    mine = (off >= 0) & (off < lps)
    flat_row = (table.gather(1, lp).long() * lps + off.clamp(0, lps - 1)).reshape(-1)
    keep = (~oob & mine).reshape(-1)
    _scatter_rows(kp.view(p_total * lps, *kp.shape[2:]), flat_row,
                  k.reshape(b * s, *k.shape[2:]), keep)
    _scatter_rows(vp.view(p_total * lps, *vp.shape[2:]), flat_row,
                  v.reshape(b * s, *v.shape[2:]), keep)
    cache["free_count"].sub_(flat.sum().to(cache["free_count"].dtype))
    pos.add_(s)
    return cache


def _paged_decode_append(cache, k, v):
    """Append one (KV, Dh) row per slot at its own position, in place,
    allocating a fresh page when a slot crosses a page boundary.  Slots past
    capacity neither allocate nor write."""
    b = k.shape[0]
    kp, vp, ps, o0 = _pages(cache)
    table = cache["page_table"]
    pos = cache["pos"]                             # (B,)
    p_total, lps = kp.shape[0], kp.shape[1]
    mp = table.shape[1]
    oob = pos >= mp * ps
    lp = torch.clamp(pos // ps, max=mp - 1).long()  # logical page (clamped)
    off = pos % ps
    need = (off == 0) & ~oob                       # page-boundary slots
    rank = torch.cumsum(need.int(), 0) - 1
    fresh = _take(cache["free_list"], cache["free_count"] - 1 - rank)
    rows = torch.arange(b, device=k.device)
    table[rows, lp] = torch.where(need, fresh, table[rows, lp])
    mine = (off >= o0) & (off < o0 + lps)          # the rank's in-page block
    flat_row = table[rows, lp].long() * lps + (off - o0).clamp(0, lps - 1)
    _scatter_rows(kp.view(p_total * lps, *kp.shape[2:]), flat_row, k[:, 0], ~oob & mine)
    _scatter_rows(vp.view(p_total * lps, *vp.shape[2:]), flat_row, v[:, 0], ~oob & mine)
    cache["free_count"].sub_(need.sum().to(cache["free_count"].dtype))
    pos.add_(1)
    return cache


def apply_attention(params, x, cfg: AttnCfg, mpo: MPOConfig, *, positions, mask,
                    kv_x=None, cache=None, phase: str = "train", chunk: bool = False):
    """Returns (y, cache).

    ``cache``: one layer's dense ring buffer ``dict(k, v, pos)`` with per-slot
    positions (``pos`` (B,)) or one position for every row (``pos`` 0-d, a
    hybrid segment's), or its paged form (k_pages / v_pages / page_table /
    free_list / free_count / pos, see ``transformer.init_cache(paged=True)``);
    either is updated in place.  ``kv_x`` makes it cross-attention: K and V
    are projected from ``kv_x`` (no rope on K), or, with a cache, taken from
    the cache's precomputed ``k`` / ``v``, which is returned unchanged.
    ``phase`` feeds the engine's per-matrix planning.
    ``chunk=True`` marks a multi-token prefill CHUNK continuing at the
    cache's current position (``transformer.prefill_chunk``): the caller
    gives offset positions and mask; the dense cache already appends a
    multi-token write at ``pos``, the paged one switches to the chunk
    append."""
    b, s = x.shape[0], x.shape[1]
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(L.apply_linear(params["wq"], x, cfg=mpo, phase=phase), h, dh)
    if kv_x is not None and cache is not None:
        # cross-attention over the K/V a prefill stored (the reference
        # projects kv_x and overwrites it: not computed here)
        if cfg.qk_norm:
            q = apply_rmsnorm(params["q_norm"], q)
        if cfg.use_rope:
            q = rope(q, positions, cfg.rope_theta)
        return _attend(params, q, cache["k"], cache["v"], cfg, mpo, mask, phase), cache
    src = x if kv_x is None else kv_x
    k = _split_heads(L.apply_linear(params["wk"], src, cfg=mpo, phase=phase), kvh, dh)
    v = _split_heads(L.apply_linear(params["wv"], src, cfg=mpo, phase=phase), kvh, dh)
    if cfg.qk_norm:
        q = apply_rmsnorm(params["q_norm"], q)
        k = apply_rmsnorm(params["k_norm"], k)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        if kv_x is None:
            k = rope(k, positions, cfg.rope_theta)
    if cache is not None and "k_pages" in cache:
        return _paged_attention(params, q, k, v, cache, cfg, mpo, mask, phase, chunk)
    if cache is not None:
        return _dense_cache_attention(params, q, k, v, cache, cfg, mpo, mask, phase), cache
    return _attend(params, q, k, v, cfg, mpo, mask, phase), cache


# --------------------------------------------------------------------------
# attention over a cache, on one device or on a mesh (``parallel.spmd``)
#
# On a mesh the cache's float leaves are DTensors
# (``parallel.sharding.cache_spec``): a dense K/V's batch over ``data`` and
# its sequence (else KV heads) over ``model``; a paged pool's in-page
# positions (else KV heads) over ``model``; its integer leaves replicated
# plain tensors.  Every write (``_scatter_rows``' ``index_put_``, the
# pages' indexed stores) goes to the rank's LOCAL block, and only for the
# rows, positions and heads it owns; none gathers a cache.  Attention runs
# on the local block: the batch rows and KV heads it owns are gathered
# after, and a sequence split combines per-rank partial softmaxes
# (``spmd.combine_softmax``).  A plain cache is its own local block
# (``spmd.local_range`` gives every dim whole), so one device runs the
# same code with every split and gather a no-op.
# --------------------------------------------------------------------------


def _partial_scores(q, k, cfg: AttnCfg, mask):
    """f32 scores (B, KV, G, Sq, Sk) of ``attention_scores`` before the
    softmax: softcap, then the mask's fill."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(cfg.head_dim)
    if cfg.attn_softcap:
        c = cfg.attn_softcap
        scores = c * torch.tanh(scores / c)
    return torch.where(mask[:, :, None], scores, DA.MASK_VALUE).float()


def _attend_local(q, k, v, cfg: AttnCfg, mask, t, seq_split: bool):
    """Attention of q (B, Sq, H', Dh) over one rank's keys k, v (B, Sk,
    KV', Dh) -> (B, Sq, KV', G, Dh); with ``seq_split`` the ranks' partial
    softmaxes over ``model`` are combined."""
    if not seq_split:
        if k.shape[2] != cfg.num_kv_heads:
            cfg = dataclasses.replace(cfg, num_kv_heads=k.shape[2])
        w = attention_scores(q, k, cfg, mask)
        return torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype), v)
    s = _partial_scores(q, k, cfg, mask)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    o = torch.einsum("bkgqs,bskd->bkgqd", e, v.float())
    y = spmd.combine_softmax(o, m, e.sum(-1, keepdim=True), t.device_mesh)
    return y.permute(0, 3, 1, 2, 4).to(v.dtype)


def _own_queries(q, mask, b0, b1, h0, h1, kvh):
    """The query rows and the query heads of KV heads [h0, h1), and the
    mask rows, a rank attends for."""
    g = q.shape[2] // kvh
    qo = q[b0:b1, :, h0 * g:h1 * g]
    return qo, (mask[b0:b1] if mask.shape[0] > 1 else mask)


def _dense_cache_attention(params, q, k, v, cache, cfg: AttnCfg, mpo: MPOConfig, mask,
                           phase: str):
    """Self-attention over a dense ring-buffer cache, written in place.

    A decode step writes one row per slot at its own position (a slot past
    ``max_len`` writes nothing); a prefill, or a cache with one scalar
    position (the hybrid family's), writes one slice at row 0's offset, its
    start clamped so that it fits, as the reference's dynamic_update_slice
    clamps it (a write past the end overwrites the last rows)."""
    kc, vc, idx = cache["k"], cache["v"], cache["pos"]
    kl, vl = spmd.local(kc), spmd.local(vc)
    (b0, b1), (s0, s1), (h0, h1) = (spmd.local_range(kc, d) for d in range(3))
    b, s = q.shape[0], q.shape[1]
    max_len, bl, sl = kc.shape[1], b1 - b0, s1 - s0
    kk, vv = k[b0:b1, :, h0:h1], v[b0:b1, :, h0:h1]
    per_slot = idx.dim() >= 1
    if per_slot and s == 1:
        pos = idx[b0:b1]
        at = pos[:, None]                          # (bl, 1)
        keep = (pos < max_len)[:, None]
    else:
        if s > max_len:
            raise ValueError(f"prompt of {s} tokens exceeds the cache's {max_len}")
        start = idx[0] if per_slot else idx
        at = (torch.clamp(start, 0, max_len - s)
              + torch.arange(s, device=q.device)).expand(bl, s)
        keep = torch.ones_like(at, dtype=torch.bool)
    keep = (keep & (at >= s0) & (at < s1)).reshape(-1)
    rows = (torch.arange(bl, device=q.device)[:, None] * sl + (at - s0).clamp(0, sl - 1))
    for c, new in ((kl, kk), (vl, vv)):
        _scatter_rows(c.view(bl * sl, *c.shape[2:]), rows.reshape(-1),
                      new.reshape(-1, *c.shape[2:]), keep)
    idx.add_(s)
    qo, mo = _own_queries(q, mask, b0, b1, h0, h1, cfg.num_kv_heads)
    y = _attend_local(qo, kl, vl, cfg, mo[..., s0:s1], kc, spmd.sharded_over(kc, 1, "model"))
    if spmd.sharded_over(kc, 2, "model"):
        y = spmd.gather(y, 2, kc.device_mesh)
    y = spmd.gather_batch(y, 0, kc).reshape(b, s, cfg.num_heads * cfg.head_dim)
    return L.apply_linear(params["wo"], y, cfg=mpo, phase=phase)


def _paged_attention(params, q, k, v, cache, cfg: AttnCfg, mpo: MPOConfig, mask,
                     phase: str, chunk: bool = False):
    """Self-attention over a paged KV cache.  Prefill attends over the
    in-hand prompt K/V; decode appends one row per slot and runs the flash
    kernel (its plain version for CPU tensors).

    ``chunk=True`` marks a prefill CHUNK starting at the slot's current
    position: it is appended by ``_paged_chunk_append``, and its queries
    attend the whole mapped span (earlier chunks included) through the
    ``gather_pages`` view under the caller's offset mask, as the reference
    computes it outside any kernel.  A one-token chunk takes the decode
    branch, as in the reference.  On a mesh the pool is not spread over
    ``data`` (pages are slot-agnostic), so every rank attends every slot."""
    kp = cache["k_pages"]
    (o0, o1), (h0, h1) = spmd.local_range(kp, 1), spmd.local_range(kp, 2)
    b, s = q.shape[0], q.shape[1]
    kvh, dh, ps = cfg.num_kv_heads, cfg.head_dim, kp.shape[1]
    kk, vv = k[:, :, h0:h1], v[:, :, h0:h1]
    seq_split = spmd.sharded_over(kp, 1, "model")
    table = cache["page_table"]
    if s > 1 and not chunk:
        _paged_prefill_append(cache, kk, vv)
        w = attention_scores(q, k, cfg, mask[..., :s])
        y = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype), v)
        return L.apply_linear(params["wo"], y.reshape(b, s, -1), cfg=mpo, phase=phase), cache
    kpl, vpl = spmd.local(kp), spmd.local(cache["v_pages"])
    mp, lps = table.shape[1], o1 - o0
    qo, _ = _own_queries(q, mask, 0, b, h0, h1, kvh)
    if s > 1:
        _paged_chunk_append(cache, kk, vv)
        kc, vc = DA.gather_pages(kpl, table), DA.gather_pages(vpl, table)
        if seq_split:                              # each local key's global position
            j = torch.arange(mp * lps, device=q.device)
            mask = mask[..., (j // lps) * ps + o0 + j % lps]
        y = _attend_local(qo, kc, vc, cfg, mask, kp, seq_split)
    else:
        _paged_decode_append(cache, kk, vv)
        lengths = torch.clamp(cache["pos"], max=mp * ps).to(torch.int32)
        bias = torch.where(mask[:, 0, 0], 0.0, DA.MASK_VALUE).float()
        qd = qo[:, 0].reshape(b, h1 - h0, -1, dh).contiguous()
        if seq_split:
            # the rank's keys: its in-page block of each of the slot's pages
            # (the bias masks those past the length); the kernel's softmax
            # statistics merge the ranks' outputs
            bias = bias.unflatten(-1, (mp, ps))[..., o0:o1].flatten(-2).contiguous()
            npages = (lengths + ps - 1) // ps
            o, m, l = DA.flash_decode_attention(
                qd, kpl, vpl, table, (npages * lps).to(torch.int32), bias,
                softcap=cfg.attn_softcap, stats=True)
            y = spmd.combine_softmax(o.float() * l, m, l, kp.device_mesh).to(q.dtype)
        else:
            y = DA.flash_decode_attention(qd, kpl, vpl, table, lengths, bias.contiguous(),
                                          softcap=cfg.attn_softcap)
        y = y[:, None]                             # (B, 1, KV', G, Dh)
    if spmd.sharded_over(kp, 2, "model"):
        y = spmd.gather(y, 2, kp.device_mesh)
    y = y.reshape(b, s, cfg.num_heads * dh)
    return L.apply_linear(params["wo"], y, cfg=mpo, phase=phase), cache


def _attend(params, q, k, v, cfg: AttnCfg, mpo: MPOConfig, mask, phase: str):
    """Softmax attention of q (B, Sq, H, Dh) over k, v (B, Sk, KV, Dh), then wo."""
    b, s = q.shape[0], q.shape[1]
    w = attention_scores(q, k, cfg, mask)          # (B,KV,G,Sq,Sk)
    y = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype), v)
    y = y.reshape(b, s, cfg.num_heads * cfg.head_dim)
    return L.apply_linear(params["wo"], y, cfg=mpo, phase=phase)


# --------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / squared-ReLU / plain GELU)
# --------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             mpo: MPOConfig) -> dict:
    p = {"w_up": L.init_linear(gen, d_model, d_ff, cfg=mpo, kind="ffn",
                               out_axis="ffn", sharded_out=True),
         "w_down": L.init_linear(gen, d_ff, d_model, cfg=mpo, kind="ffn",
                                 in_axis="ffn", sharded_in=True, scale=d_ff ** -0.5)}
    if act in ("silu", "gelu"):  # gated variants (SwiGLU / GeGLU)
        p["w_gate"] = L.init_linear(gen, d_model, d_ff, cfg=mpo, kind="ffn",
                                    out_axis="ffn", sharded_out=True)
    return p


def apply_mlp(params, x, act: str, mpo: MPOConfig, phase: str = "train"):
    up = L.apply_linear(params["w_up"], x, cfg=mpo, phase=phase)
    if act == "silu":
        h = F.silu(L.apply_linear(params["w_gate"], x, cfg=mpo, phase=phase)) * up
    elif act == "gelu":
        g = L.apply_linear(params["w_gate"], x, cfg=mpo, phase=phase)
        h = F.gelu(g, approximate="tanh") * up
    elif act == "relu2":
        h = torch.square(F.relu(up))
    elif act == "gelu_plain":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(act)
    return L.apply_linear(params["w_down"], h, cfg=mpo, phase=phase)
