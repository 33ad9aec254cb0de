"""Train / eval / serve step functions — the port of ``repro.train.steps``.

``make_train_step`` builds the step: forward (each layer recomputed in the
backward when ``cfg.remat``), loss, backward over EVERY parameter leaf (as
``jax.value_and_grad`` differentiates every leaf, so ``grad_norm`` equals the
reference's), then the masked optimizer, which updates the parameters in
place.  Every MPO matmul inside runs through the engine's ``train``-phase
plan; on the card that is the fused MPO-linear kernels, forward and
backward (``kernels.mpo_linear.MPOLinearFn``).  Mesh-sharded serving comes
with meshes (ROADMAP.md, Queue 1 item 8).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch.core.lightweight import leaves, tree_map
from repro_torch.data.pipeline import IGNORE
from repro_torch.models import transformer
from repro_torch.models.model import Model, differentiable
from repro_torch.optim.optimizers import Optimizer, OptState


class TrainState(NamedTuple):
    params: Any            # nested dict of the model's parameters (updated in place)
    opt_state: OptState


def cross_entropy(logits, labels):
    """Sum of CE over valid labels + valid count.  labels==IGNORE skipped."""
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0).long()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    ce = torch.where(valid, lse - gold, 0.0)
    return ce.sum(), valid.sum()


def lm_loss(model: Model, params, batch):
    """(mean CE, metrics).  Chunked over the sequence when cfg.loss_chunk>0,
    each chunk's logits recomputed in the backward (as the reference's
    ``jax.checkpoint``-ed scan body)."""
    cfg = model.cfg
    chunk = cfg.loss_chunk
    hidden = transformer.forward_hidden(params, batch, cfg, phase="train")
    labels = batch["labels"]
    s = hidden.shape[1]
    # global next-token shift (boundary-safe under chunking)
    shifted = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], IGNORE)], dim=1)

    def head_ce(h, lab):
        return cross_entropy(transformer.logits_head(params, h, cfg, phase="train"), lab)

    if chunk and s % chunk == 0 and s > chunk:
        ce = torch.zeros((), device=hidden.device)
        n = torch.zeros((), device=hidden.device)
        for c0 in range(0, s, chunk):
            h, lab = hidden[:, c0:c0 + chunk], shifted[:, c0:c0 + chunk]
            if torch.is_grad_enabled():
                c_ce, c_n = torch.utils.checkpoint.checkpoint(head_ce, h, lab,
                                                               use_reentrant=False)
            else:
                c_ce, c_n = head_ce(h, lab)
            ce, n = ce + c_ce, n + c_n
    else:
        ce, n = head_ce(hidden, shifted)
    loss = ce / torch.clamp(n.float(), min=1.0)
    aux = torch.zeros((), device=hidden.device)      # dense family: no aux loss
    return loss + 0.01 * aux, {"loss": loss, "aux": aux, "tokens": n}


def make_train_step(model: Model, optimizer: Optimizer,
                    loss_fn: Callable | None = None):
    """``train_step(state, batch) -> (state, metrics)``; ``batch`` holds
    tensors on the model's device."""
    loss_fn = loss_fn or (lambda p, b: lm_loss(model, p, b))

    def train_step(state: TrainState, batch):
        flat = list(leaves(state.params))
        with differentiable(flat):
            loss, metrics = loss_fn(state.params, batch)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        # a detached (frozen) leaf gets no gradient: zero, as stop_gradient gives
        grads = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)}
        grads = tree_map(lambda p: grads[id(p)], state.params)
        opt_state = optimizer.update(grads, state.opt_state, state.params)
        with torch.no_grad():
            gnorm = torch.sqrt(sum(g.float().square().sum() for g in leaves(grads)))
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        return TrainState(state.params, opt_state), dict(metrics, grad_norm=gnorm)

    return train_step


def make_eval_step(model: Model, loss_fn: Callable | None = None):
    loss_fn = loss_fn or (lambda p, b: lm_loss(model, p, b))

    @torch.no_grad()
    def eval_step(params, batch):
        return loss_fn(params, batch)[1]

    return eval_step


def make_cls_loss(cfg):
    """Classification loss (the paper's GLUE-analog experiments): CE of the
    first-token classifier, with accuracy in the metrics."""

    def loss_fn(params, batch):
        logits = transformer.forward_cls(params, batch, cfg)
        labels = batch["labels"].long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        ce = -logp.gather(-1, labels[:, None]).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        aux = torch.zeros((), device=logits.device)  # dense family: no aux loss
        return ce + 0.01 * aux, {"loss": ce, "acc": acc, "aux": aux}

    return loss_fn


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


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
                                  "Queue 1 item 8")
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
