"""Serving steps — the part of ``repro.train.steps`` the serving path needs.

The train/eval steps and losses come with training (ROADMAP.md, Queue 1
item 5); mesh-sharded serving with meshes (item 13).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.model import Model


class ServeSteps(NamedTuple):
    """The serving step bundle ``make_serve_steps`` returns."""

    prefill: Any
    decode: Any
    init_serve: Any


def make_serve_steps(model: Model, *, weight_cache: bool = True, mesh=None,
                     paged: bool = False, page_size: int = 16) -> ServeSteps:
    """``ServeSteps(prefill, decode, init_serve)`` for batched serving.

    ``init_serve(params, batch, max_len)`` runs ONCE per serving session: it
    allocates the KV cache (per-slot positions; paged when ``paged``) and —
    when ``weight_cache`` — contracts every factorized matrix whose decode
    plan is ``cached`` into its dense W, returning ``(serve_params, cache)``.
    Pass the returned ``serve_params`` to the steps.  The weight cache is a
    SNAPSHOT of the cores: re-run ``init_serve`` after any core mutation.

    ``decode(params, tokens, cache)`` returns ``(next_tokens (B, 1) int32,
    logits, cache)`` with greedy argmax; both steps update ``cache`` in place.
    """
    if mesh is not None:
        raise NotImplementedError("mesh-sharded serving comes with ROADMAP.md, "
                                  "Queue 1 item 13")
    cache_kw = {"paged": True, "page_size": page_size} if paged else {}

    def init_serve(params, batch: int, max_len: int):
        cache = model.init_cache(batch, max_len, **cache_kw)
        serve_params = model.cache_weights(params) if weight_cache else params
        return serve_params, cache

    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache, phase="prefill")

    def decode_step(params, tokens, cache):
        logits, cache = model.decode_step(params, tokens, cache, phase="decode")
        next_tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        return next_tok, logits, cache

    return ServeSteps(prefill_step, decode_step, init_serve)
