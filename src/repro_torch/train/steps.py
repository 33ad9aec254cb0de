"""Train / eval / serve step functions — the port of ``repro.train.steps``.

``make_train_step`` builds the step: forward (each layer recomputed in the
backward when ``cfg.remat``), loss, backward over EVERY parameter leaf (as
``jax.value_and_grad`` differentiates every leaf, so ``grad_norm`` equals the
reference's), then the masked optimizer, which updates the parameters in
place.  Every MPO matmul inside runs through the engine's ``train``-phase
plan; on the card that is the fused MPO-linear kernels, forward and
backward (``kernels.mpo_linear.MPOLinearFn``).

On a mesh (``parallel.spmd``) both run over DTensors placed by
``parallel.sharding``: ``make_train_step`` spreads the batch rows over the
batch axes (``batch_sharding``: data parallelism, each rank runs its own
rows and the gradients are summed over those axes), differentiates into
DTensor parameters and the optimizers update them in place; ``make_serve_steps(
mesh=, rules=, axes=)`` places the serving snapshot and the cache by the
rules and returns logits and tokens as plain tensors, the same on every
rank, for the host loop.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch.core.lightweight import leaves, tree_map
from repro_torch.data.pipeline import IGNORE
from repro_torch.models import transformer
from repro_torch.models.model import Model, differentiable
from repro_torch.optim.optimizers import Optimizer, OptState
from repro_torch.parallel import spmd
from repro_torch.parallel.ctx import maybe_mesh, sequence_parallel


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
    if model.mod is transformer:
        hidden, aux = model.mod.forward_hidden(params, batch, cfg, phase="train",
                                               with_aux=True)
    else:                                     # ssm, hybrid, encdec: no aux loss
        hidden = model.mod.forward_hidden(params, batch, cfg, phase="train")
        aux = torch.zeros((), device=hidden.device)
    labels = batch["labels"]
    s = hidden.shape[1]
    if labels.shape[1] != s:          # vlm: labels cover the patches and the text
        labels = labels[:, -s:]
    # global next-token shift (boundary-safe under chunking)
    shifted = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], IGNORE)], dim=1)

    def head_ce(h, lab):
        return cross_entropy(model.mod.logits_head(params, h, cfg, phase="train"), lab)

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
    return loss + 0.01 * aux, {"loss": loss, "aux": aux, "tokens": n}


def make_train_step(model: Model, optimizer: Optimizer,
                    loss_fn: Callable | None = None):
    """``train_step(state, batch) -> (state, metrics)``; ``batch`` holds
    tensors on the model's device, every row on every rank.  On a mesh each
    rank runs the rows ``batch_sharding`` gives it (over the batch axes);
    the loss is the mean of the ranks' losses, and the metrics are averaged
    over them (``tokens`` summed)."""
    loss_fn = loss_fn or (lambda p, b: lm_loss(model, p, b))

    def train_step(state: TrainState, batch):
        flat = list(leaves(state.params))
        mesh = flat[0].device_mesh if spmd.is_dtensor(flat[0]) else None
        axes, n = (), 1
        if mesh is not None:
            from repro_torch.parallel import sharding as S
            batch, axes = spmd.take_rows(batch, S.batch_sharding(batch, mesh,
                                                                  S.make_rules(mesh)), mesh)
            n = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)
        with differentiable(flat), maybe_mesh(mesh), \
                sequence_parallel(mesh is not None and model.cfg.parallelism == "sp"):
            # on a mesh the model runs on the ranks' shards (parallel.spmd)
            loss, metrics = loss_fn(spmd.localize(state.params, axes) if mesh
                                    else state.params, batch)
            grads = torch.autograd.grad(loss / n, flat, allow_unused=True)
        if axes:
            spmd.sum_grads(grads, flat, axes, mesh)
        # a detached (frozen) leaf gets no gradient: zero, as stop_gradient gives
        grads = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)}
        grads = tree_map(lambda p: grads[id(p)], state.params)
        with _replicate_scalars(mesh):
            opt_state = optimizer.update(grads, state.opt_state, state.params)
        with torch.no_grad():
            gnorm = torch.sqrt(sum(_whole(g.float().square().sum()) for g in leaves(grads)))
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        if axes:                                   # the ranks' mean (tokens: their sum)
            sums = {k: spmd.all_sum(v, mesh, axes) for k, v in metrics.items()
                    if isinstance(v, torch.Tensor)}
            metrics.update({k: v if k == "tokens" else v / n for k, v in sums.items()})
        return TrainState(state.params, opt_state), dict(metrics, grad_norm=gnorm)

    return train_step


def _whole(t):
    """A DTensor scalar (a sum over shards) as a plain tensor."""
    return t.full_tensor() if spmd.is_dtensor(t) else t


def _replicate_scalars(mesh):
    """On a mesh: let the optimizers' plain scalar tensors (bias
    corrections, step counts) meet DTensor leaves as replicated values."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


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
    """The serving step bundle ``make_serve_steps`` returns.  Unpacks like
    the reference's (``prefill, decode, init_serve, chunk = ...``);
    ``prefill_chunk`` is ``None`` for families without one (``ssm``,
    ``hybrid``, ``encdec``)."""

    prefill: Any
    decode: Any
    init_serve: Any
    prefill_chunk: Any = None


def make_serve_steps(model: Model, *, weight_cache: bool = True, mesh=None,
                     rules: dict | None = None, axes=None,
                     paged: bool = False, page_size: int = 16,
                     pool_pages: int | None = None) -> ServeSteps:
    """``ServeSteps(prefill, decode, init_serve, prefill_chunk)`` for
    batched serving.

    ``init_serve(params, batch, max_len)`` runs ONCE per serving session: it
    allocates the cache (the KV cache with per-slot positions, paged when
    ``paged``; the SSM state tensor for the ``ssm`` family; the hybrid's and
    encdec's caches, ``Model.init_cache``) and —
    when ``weight_cache`` — contracts every factorized matrix whose decode
    plan is ``cached`` into its dense W in the config's activation dtype,
    returning ``(serve_params, cache)``.
    Pass the returned ``serve_params`` to the steps.  ``serve_params`` is a
    SNAPSHOT of the weights, as the reference's immutable arrays are: the
    dense W it contracts, and a clone of every leaf it passes through
    (the optimizers update the live tensors in place), so a handle keeps
    serving the weights it was built from; at most one copy of the tree a
    handle.  Re-run ``init_serve`` to serve weights changed since.

    ``prefill(params, batch, cache)`` takes the batch dict: ``tokens``, and
    for the ``vlm`` family ``patches`` (put ahead of the text), for the
    ``encdec`` family ``frames`` (the encoder's input).  The weight
    cache covers expert stacks: a MoE layer's expert matrices are contracted
    into ``(L, E, I, J)`` W like any stacked matrix.
    ``decode(params, tokens, cache)`` returns ``(next_tokens (B, 1) int32,
    logits, cache)`` with greedy argmax; ``prefill_chunk(params, batch,
    cache)`` continues a prefill at the cache's current offsets and returns
    the logits of EVERY chunk position (``None`` for the ``ssm``,
    ``hybrid`` and ``encdec`` families).
    Every step updates ``cache`` in place.  ``pool_pages`` oversubscribes
    the paged pool below ``batch * max_pages`` (only behind ``ServePool``'s
    page-reservation admission).

    Mesh-sharded serving, every family (``mesh=`` a ``DeviceMesh``,
    optional ``rules=``, required ``axes=``, the logical-axis tree
    ``model.axes``): the rules pass through ``head_safe_rules``;
    ``init_serve`` contracts the weight cache with ``cache_weights(axes=...)``
    so each dense W inherits its cores' layout (tensor- or
    expert-parallel), and places the snapshot
    (``parallel.sharding.tree_shardings``: matrices that stay factorized
    keep per-core placements, never a replicated dense table) and the cache
    (``cache_sharding``: batch over ``data``, the sequence over ``model`` —
    the flash-decoding layout; integer leaves replicated; the hybrid's and
    encdec's nested caches leaf by leaf) as DTensors, each rank cutting its
    own blocks (a snapshot, as above).  The steps run
    under ``maybe_mesh(mesh)`` on the rank's shards (``parallel.spmd``) and
    return logits and next tokens as plain tensors, the same on every rank;
    ``prefill_chunk`` runs under the mesh too.  Example::

        mesh = make_host_mesh(model=2, device_type="cpu")   # 4 ranks: (2, 2)
        prefill, decode, init_serve, _ = make_serve_steps(
            model, mesh=mesh, axes=model.axes)
        sparams, cache = init_serve(model.tree(), 8, 128)
    """
    cache_kw = {"paged": True, "page_size": page_size} if paged else {}
    if paged and pool_pages is not None:
        cache_kw["pool_pages"] = pool_pages

    def init_serve(params, batch: int, max_len: int):
        cache = model.init_cache(batch, max_len, **cache_kw)
        serve_params = model.cache_weights(params) if weight_cache else params
        live = {id(t) for t in leaves(params)}
        snapshot = tree_map(lambda t: t.detach().clone() if id(t) in live else t, serve_params)
        return snapshot, cache

    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache, phase="prefill")

    def decode_step(params, tokens, cache):
        logits, cache = model.decode_step(params, tokens, cache, phase="decode")
        next_tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        return next_tok, logits, cache

    prefill_chunk_step = None
    if model.prefill_chunk is not None:
        chunk = model.prefill_chunk

        def prefill_chunk_step(params, batch, cache):
            return chunk(params, batch, cache, phase="prefill")

    if mesh is None:
        return ServeSteps(prefill_step, decode_step, init_serve, prefill_chunk_step)

    from repro_torch.parallel import sharding as S

    if axes is None:
        raise ValueError(
            "make_serve_steps(mesh=...) needs axes= (the logical-axis tree "
            "from model.axes / layers.axes_for) to place the serving params on "
            "the mesh")
    rules = S.make_rules(mesh) if rules is None else rules
    # never let a K/V projection shard split head_dim across ranks
    rules = S.head_safe_rules(rules, model.cfg, mesh)

    def init_serve_mesh(params, batch: int, max_len: int):
        cache = model.init_cache(batch, max_len, **cache_kw)
        if weight_cache:
            serve_params, serve_axes = model.cache_weights(params, axes=axes)
        else:
            serve_params, serve_axes = params, axes
        placed = S.place_tree(serve_params, S.tree_shardings(serve_axes, serve_params, mesh,
                                                             rules), mesh)
        return placed, S.place_tree(cache, S.cache_sharding(cache, mesh, rules), mesh)

    def on_mesh(step):
        def run(params, batch, cache):
            with maybe_mesh(mesh):
                out = step(spmd.localize(params), batch, spmd.cache_views(cache))
            return (*out[:-1], cache)              # the cache was updated in place
        return run

    return ServeSteps(on_mesh(prefill_step), on_mesh(decode_step), init_serve_mesh,
                      None if prefill_chunk_step is None else on_mesh(prefill_chunk_step))
