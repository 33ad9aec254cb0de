"""``Session``: the stage-based lifecycle API — the port of
``repro.pipeline.session``: conversion, fine-tuning, squeezing and serving.

    Session.from_dense(dense, cfg)  MPO-decompose a dense tree (Algorithm 1),
        │                           per-matrix conversion error report
        │   (or Session.init(cfg)   fresh MPO-parameterized model)
        ▼
    .finetune(mode="lfa")           trainability mask + masked optimizer +
        │                           train loop (auxiliary tensors only)
        ▼
    .squeeze(delta=...)             dimension squeezing (Algorithm 2): truncate
        │                           the least-error bond, re-tune, evaluate on
        │                           a fresh weight snapshot, stop on the gap
        ▼
    .serve(batch, max_len)          one-time init_serve (KV cache + cached-W
        │                           contraction) -> prefill/decode handle
        ▼
    .report()                       compression ratio, trainable reduction,
                                    conversion errors, squeeze events, stage
                                    timings

A densified weight-cache snapshot is only valid for the cores it was taken
from: ``finetune`` and ``squeeze`` bump the weights version, so a later
``serve`` re-densifies from the current cores.  The ``dense``, ``ssm``
(mamba2-130m, whose SSD scan trains through the backward kernel
``kernels.ssd_scan.ssd_scan_bwd``), ``vlm``, ``hybrid`` and ``encdec``
(whisper-tiny: batches carry ``frames``) families run every stage here;
``serve_pool`` and ``serve_fleet`` refuse ``vlm``, ``hybrid`` and
``encdec``, as the reference's ``ServePool`` does.  The ``moe`` family fine-tunes (its expert matrices through the cores
backward over the expert stack) and serves (also ``serve_pool`` and
``serve_fleet``); its conversion and squeezing raise, as the reference's
Algorithm 1 and 2 fail on (L, E) expert stacks (``core.convert`` and
``core.squeeze``: ``EXPERT_STACKS``).
``save`` / ``restore`` persist the whole session (``resilience.state``), and
``ckpt_dir`` makes ``finetune`` (checkpoint/resume) and ``squeeze`` (the
iteration journal) resumable after a preemption.  ``serve_pool`` serves
many tenants through one continuously batched ``ServePool``
(``pipeline.scheduler``), and ``serve_fleet`` puts replicas of it behind a
``PoolRouter`` (``pipeline.router``) that retries, trips, rebuilds and
sheds.  The session's device is the card unless the caller passes
``device="cpu"``; there is no silent move to the CPU.

``serve(mesh=)``, ``serve_pool(mesh=)`` and ``serve_fleet`` place the
serving snapshot and the cache on a ``DeviceMesh`` by the session's
logical-axis tree (``axes``, kept by ``init``, ``from_dense`` and
``restore``) and the rules of ``parallel.sharding``, for every family that
serves that way off the mesh (a moe layer's experts spread over ``model``,
nested caches placed leaf by leaf); every rank runs the same calls and
gets the same tokens.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import carry, convert, lightweight
from repro_torch.core import squeeze as squeeze_mod
from repro_torch.core.engine import engine_for
from repro_torch.data.pipeline import SyntheticCLS, make_batch_fn
from repro_torch.kernels import autotune
from repro_torch.models import model as M
from repro_torch.optim import optimizers, schedule
from repro_torch.parallel import spmd
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.steps import (TrainState, lm_loss, make_cls_loss,
                                     make_serve_steps, make_train_step)

@dataclasses.dataclass(frozen=True)
class StageRecord:
    """One completed stage transition, for ``Session.report()``."""
    stage: str
    seconds: float
    info: dict


class ServeHandle:
    """A bound serving session: prefill/decode steps over a weight snapshot
    taken ONCE at construction (cache allocation + ``cache_weights``
    densification).  Carries the weights version it was built from so
    ``Session.serve`` can detect staleness.  The cache — the KV cache's dict
    of tensors, or the SSM family's ``(L, B, H, N, P)`` state tensor — is
    updated in place, and ``reset`` rewinds it in place: the handle holds
    one cache.
    Example::

        handle = session.serve(batch_size=8, max_len=64)
        out = handle.generate({"tokens": prompts}, num_tokens=16)  # (8, 16)
    """

    def __init__(self, model: M.Model, params, batch_size: int, max_len: int, *,
                 weight_cache: bool = True, version: int = 0, mesh=None, rules=None,
                 axes=None, paged: bool = False, page_size: int = 16):
        self.batch_size, self.max_len = batch_size, max_len
        self.weight_cache = weight_cache
        self.version = version
        self.mesh = mesh
        self.paged = paged
        self.device = model.device
        self._prefill, self._decode, self._init_serve, _ = make_serve_steps(
            model, weight_cache=weight_cache, mesh=mesh, rules=rules, axes=axes,
            paged=paged, page_size=page_size)
        self._reset_cache = model.reset_cache
        t0 = time.perf_counter()
        with torch.no_grad():
            self.params, self.cache = self._init_serve(params, batch_size, max_len)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.init_seconds = time.perf_counter() - t0

    @torch.no_grad()
    def reset(self) -> "ServeHandle":
        """Rewind the (in-place updated) cache to its empty initial state."""
        self._reset_cache(spmd.cache_views(self.cache, all_leaves=True))
        return self

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.tensor(x, device=self.device)

    @torch.no_grad()
    def prefill(self, batch: dict) -> torch.Tensor:
        batch = {k: self._tensor(v) for k, v in batch.items()}
        logits, self.cache = self._prefill(self.params, batch, self.cache)
        return logits

    @torch.no_grad()
    def decode(self, tokens):
        tok, logits, self.cache = self._decode(self.params, self._tensor(tokens),
                                               self.cache)
        return tok, logits

    @torch.no_grad()
    def generate(self, batch: dict, num_tokens: int) -> torch.Tensor:
        """Greedy generation: prefill the prompt, decode ``num_tokens``.
        Returns (batch, num_tokens) int32 token ids."""
        self.reset()
        logits = self.prefill(batch)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out = [tok]
        for _ in range(num_tokens - 1):
            tok, _ = self.decode(tok)
            out.append(tok)
        return torch.cat(out, dim=1)


def _refuse_expert_stacks(cfg: ModelConfig, what: str, why: str):
    """The moe family's experts are (L, E) stacks, which the reference's
    Algorithm 1 and 2 cannot take: raise ``why`` before any work."""
    if cfg.family == "moe":
        raise NotImplementedError(f"{what} for the moe family: {why}")


class Session:
    """Owns the model, its params, the ``MPOEngine`` and weight-cache
    validity.  Example::

        from repro_torch import Session
        s = Session.init("bert-base", smoke=False)        # on the card
        out = s.serve(8, 256, paged=True).generate(batch, num_tokens=32)
        print(s.report())
    """

    def __init__(self, cfg: ModelConfig, model: M.Model, axes=None):
        self.cfg = cfg
        self.model = model
        # the logical-axis tree (layers.axes_for) that places the weights
        # on a mesh; a session built raw without it cannot serve on one
        self.axes = axes
        self.engine = engine_for(cfg.mpo)
        self.stage = "init"
        self._records: list[StageRecord] = []
        self._version = 0                 # bumped on every core mutation
        # (batch, max_len, weight_cache, paged, page_size) -> ServeHandle at
        # _version; cleared on every bump so a stale snapshot is never reused
        self._serve: dict[tuple, ServeHandle] = {}
        self.mask = None                  # last trainability mask
        self._loss_default: Callable | None = None
        self.conversion_report: dict = {}  # matrix path -> relative error
        self.squeeze_history: list = []
        # every ServePool this session built, weakly: a pool the caller
        # dropped stops pinning its snapshot and leaves report()
        self._pools: list[weakref.ref] = []

    @property
    def params(self) -> dict:
        return self.model.tree()

    @property
    def device(self) -> torch.device:
        return self.model.device

    # ---- constructors ----

    @classmethod
    def init(cls, cfg: ModelConfig | str, *, seed: int = 0, smoke: bool = True,
             device=None, init_device="cpu", **overrides) -> "Session":
        """Fresh MPO-parameterized model on ``device`` (the card when None;
        raises if there is none), its weights drawn on ``init_device`` (the
        CPU: the same weights on every device; ``"cuda"`` draws a full-width
        model on the card, other weights from the same seed).  ``cfg`` may be
        a ``ModelConfig`` or an arch name (``smoke=True`` scales it down to
        the CPU-sized config the tests use); ``overrides`` replace config
        fields either way."""
        if isinstance(cfg, str):
            cfg = (configs.smoke_config(cfg, **overrides) if smoke
                   else configs.get_config(cfg, **overrides))
        elif overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        t0 = time.perf_counter()
        model = M.build(cfg, seed=seed, device=device, init_device=init_device)
        s = cls(cfg, model, model.axes)
        s._record("init", t0, {"params": lightweight.count_params(s.params)})
        return s

    @classmethod
    def from_dense(cls, dense_params: dict, cfg: ModelConfig, *, report: bool = True,
                   device=None) -> "Session":
        """The paper's workflow: MPO-decompose a *pretrained* dense tree
        (Algorithm 1) into this config's core layout (bond-truncated per the
        config), on ``device`` (the card when None), with a per-matrix
        relative reconstruction error report (Eq. 4 drift).
        ``dense_params`` is the tree of the same architecture built with
        ``MPOConfig(enabled=False)``, as tensors or numpy arrays; the MPO
        model built here gives the core shapes, and its drawn values are
        replaced."""
        _refuse_expert_stacks(cfg, "Session.from_dense", convert.EXPERT_STACKS)
        t0 = time.perf_counter()
        model = M.build(cfg, device=device, init_device=device)   # a template: drawn in place
        dense = lightweight.tree_map(lambda t: carry.to_tensor(t).to(model.device),
                                     dense_params)
        with torch.no_grad():
            model.set_tree(convert.convert_dense_to_mpo(dense, model.tree()))
        s = cls(cfg, model, model.axes)
        if report:
            s.conversion_report = convert.conversion_error(dense, s.params)
        errs = s.conversion_report
        s._record("from_dense", t0, {"matrices": len(errs),
                                     "max_rel_err": max(errs.values(), default=0.0)})
        return s

    def serve_pool(self, slots: int, max_len: int, *, weight_cache: bool = True,
                   mesh=None, rules=None, paged: bool = False, page_size: int = 16,
                   pool_pages: int | None = None, admission_retry_limit: int = 1000,
                   guard_logits: bool = True, prefill_chunk: int | None = None,
                   bucket_prompts: bool = False, bucket_min: int = 8, clock=None):
        """Multi-tenant batched decode over the CURRENT weights: a
        ``pipeline.scheduler.ServePool`` with ``slots`` decode rows.
        Requests are admitted into free slots (batch-1 prefill copied into
        the pool cache), one decode step advances ALL live tenants, and
        finished slots are recycled without re-prefilling anyone.  Pool
        stats surface in ``report()`` while the caller holds the pool.

        Like ``serve()``, the pool snapshots the weights at construction;
        build a new pool after any ``finetune``/``squeeze``.  ``pool_pages``
        oversubscribes the paged KV pool (admission then backpressures on
        page reservations), ``guard_logits`` quarantines a slot whose logits
        go NaN/inf, ``admission_retry_limit`` bounds the backpressure
        retries; ``bucket_prompts`` pads prompts to power-of-two lengths and
        ``prefill_chunk=N`` streams admission N tokens a step, both giving
        the whole-prompt admission's tokens.  ``clock=`` is the time source
        of deadlines and budgets (``pipeline.clock``).  Example::

            pool = session.serve_pool(slots=4, max_len=64, paged=True)
            rids = [pool.submit(p, max_new_tokens=16) for p in prompts]
            outputs = pool.run()            # {rid: token ids}
        """
        from repro_torch.pipeline.scheduler import ServePool  # lazy
        if mesh is not None and self.axes is None:
            raise ValueError(
                "Session.serve_pool(mesh=...) needs the logical-axis tree; "
                "build the session via Session.init/from_dense")
        t0 = time.perf_counter()
        pool = ServePool(self.model, self.params, slots, max_len,
                         weight_cache=weight_cache, mesh=mesh, rules=rules,
                         axes=self.axes if mesh is not None else None,
                         version=self._version, paged=paged,
                         page_size=page_size, pool_pages=pool_pages,
                         admission_retry_limit=admission_retry_limit,
                         guard_logits=guard_logits, prefill_chunk=prefill_chunk,
                         bucket_prompts=bucket_prompts, bucket_min=bucket_min,
                         clock=clock)
        self._pools = [r for r in self._pools if r() is not None]
        self._pools.append(weakref.ref(pool))
        self._record("serve", t0, {"pool": True, "slots": slots, "max_len": max_len,
                                   "init_seconds": pool.init_seconds})
        return pool

    def serve_fleet(self, replicas: int, slots: int, max_len: int, *,
                    session_dir: str | None = None, clock=None,
                    router: dict | None = None, **pool_kw):
        """A replicated serving fleet behind one ``PoolRouter``: ``replicas``
        pools over the CURRENT weights, least-loaded routing,
        retry-on-another-replica with capped backoff, per-replica circuit
        breaking and queue-depth load shedding, behind the surface a single
        pool has (``traffic.replay`` drives it unchanged).

        ``session_dir``: the session is saved there ONCE, and a tripped or
        crashed replica is rebuilt by ``Session.restore(session_dir,
        device=self.device).serve_pool(...)`` — on this session's device.
        Without it a rebuild snapshots this live session's weights again.
        ``router`` kwargs pass through to ``PoolRouter``; ``pool_kw`` to
        every ``serve_pool`` replica.  All replicas, the router and any
        replay loop share ONE ``clock``.  Example::

            router = session.serve_fleet(3, 4, 64, paged=True, session_dir="runs/fleet")
            outputs = router.run()
        """
        from repro_torch.pipeline.clock import WallClock  # lazy
        from repro_torch.pipeline.router import PoolRouter  # lazy
        if replicas < 1:
            raise ValueError(f"replicas={replicas} must be >= 1")
        clock = WallClock() if clock is None else clock
        pools = [self.serve_pool(slots, max_len, clock=clock, **pool_kw)
                 for _ in range(replicas)]
        if session_dir is not None:
            self.save(session_dir)
            device = self.device

            def rebuild():
                restored = Session.restore(session_dir, device=device)
                return restored.serve_pool(slots, max_len, clock=clock, **pool_kw)
        else:
            def rebuild():
                return self.serve_pool(slots, max_len, clock=clock, **pool_kw)
        return PoolRouter(pools, rebuild_fn=rebuild, clock=clock, **(router or {}))

    # ---- persistence ----

    def save(self, directory: str) -> str:
        """Persist the FULL session under ``directory`` — weights (atomic
        ``CheckpointManager`` step dirs), stage records, squeeze history,
        trainability mask, conversion report and weights version — behind
        one atomically written manifest (``resilience.state``, the
        reference's layout): a crash at any point leaves the directory at
        either the previous complete session or the new one.  Returns the
        directory.  Example::

            session.save("runs/compressed")
            ...                              # preemption / new process
            s = Session.restore("runs/compressed")
            s.serve(8, 64)                   # token-identical serving
        """
        from repro_torch.resilience import state as rstate  # lazy
        return rstate.save_session(self, directory)

    @classmethod
    def restore(cls, directory: str, *, device=None) -> "Session":
        """Rebuild a session from ``save(directory)`` (or from the JAX
        package's ``Session.save``) on ``device`` — the card when None,
        raising if there is none: the model from the serialized config,
        the weights (squeezed bonds included) from the manifest's
        checkpoint step, and the lifecycle state (stage, records, squeeze
        history, mask, weights version) from the manifest, so the restored
        session reports and serves exactly like the one that was saved."""
        from repro_torch.resilience import state as rstate  # lazy
        return rstate.restore_session(directory, cls=cls, device=device)

    # ---- bookkeeping ----

    def _record(self, stage: str, t0: float, info: dict):
        self.stage = stage
        self._records.append(StageRecord(stage, time.perf_counter() - t0, info))

    def _bump(self):
        """Core mutation: any weight-cache snapshot is now stale."""
        self._version += 1
        self._serve.clear()

    @property
    def weights_version(self) -> int:
        return self._version

    # ---- task defaults (cls vs lm) ----

    @property
    def task(self) -> str:
        return "cls" if self.cfg.num_classes else "lm"

    def _default_loss_fn(self) -> Callable:
        if self._loss_default is None:
            self._loss_default = (
                make_cls_loss(self.cfg) if self.task == "cls"
                else lambda p, b: lm_loss(self.model, p, b))
        return self._loss_default

    def _default_batch_fn(self, seq_len: int, batch_size: int, seed: int) -> Callable:
        if self.task == "cls":
            ds = SyntheticCLS(self.cfg.vocab_size, seq_len, batch_size,
                              num_classes=self.cfg.num_classes, seed=seed)
            return ds.batch
        shape = ShapeConfig("pipeline", "train", seq_len, batch_size)
        return make_batch_fn(self.cfg, shape, seed=seed)

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    # ---- finetune ----

    def finetune(self, *, mode: str = "lfa", steps: int = 60,
                 lr: float | Callable = 2e-3, warmup: int = 0,
                 weight_decay: float = 0.0, seq_len: int = 32,
                 batch_size: int = 16, seed: int = 0, mask=None,
                 optimizer=None, loss_fn: Callable | None = None,
                 batch_fn: Callable | None = None, ckpt_dir: str | None = None,
                 ckpt_every: int = 100, log_every: int = 50, donate: bool = False,
                 verbose: bool = False) -> dict:
        """Lightweight fine-tuning (paper §4.1): the trainability mask
        (``mode="lfa"`` freezes the central tensors), a masked AdamW (frozen
        leaves allocate no state and receive no updates), and the train
        loop.  Every MPO matmul of the step runs through the engine's
        ``train``-phase plan — on the card the fused MPO-linear kernels,
        forward and backward.  The parameters update in place, so ``donate``
        has nothing to do and is accepted for the reference's signature.
        ``ckpt_dir`` enables checkpoint/resume (an async save every
        ``ckpt_every`` steps, a blocking one at the end and on preemption;
        a rerun with the same ``ckpt_dir`` resumes at its latest step).
        Returns a stage report with the loss history.  In the ``ssm``
        family the SSD scan runs through ``SSDScanFn``: its forward and
        backward kernels on the card; in the ``moe`` family each expert
        matrix's stack runs one forward and one cores-backward call a
        layer (the history reports the load-balance ``aux``); ``vlm``
        batches carry patches (``seq_len`` counts them), ``encdec`` batches
        frames (``seq_len`` counts the decoder's tokens alone)."""
        t0 = time.perf_counter()
        loss_fn = loss_fn or self._default_loss_fn()
        batch_fn = batch_fn or self._default_batch_fn(seq_len, batch_size, seed)
        if mask is None and optimizer is None:
            mask = lightweight.trainable_mask(self.params, mode=mode)
        # a caller-supplied optimizer owns its own masking: no mode-derived
        # mask is made for it, so the counts below claim no freezes
        if optimizer is None:
            lr_fn = lr if (callable(lr) or not warmup) else \
                schedule.cosine_warmup(lr, warmup=warmup, total=steps)
            optimizer = optimizers.adamw(lr_fn, weight_decay=weight_decay, mask=mask)
        step_fn = make_train_step(self.model, optimizer, loss_fn=loss_fn)
        state = TrainState(self.params, optimizer.init(self.params))
        loop = LoopConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                          log_every=max(1, min(log_every, steps)))
        log = print if verbose else (lambda *a, **k: None)
        _, history = run_training(step_fn, state, batch_fn, loop,
                                  to_device=self._to_device, log_fn=log)
        self.mask = mask
        self._bump()
        info = {"mode": mode, "steps": steps,
                "total": lightweight.count_params(self.params),
                "loss_first": history[0]["loss"] if history else None,
                "loss_final": history[-1]["loss"] if history else None}
        if mask is not None:
            tr, tot = lightweight.count_trainable(self.params, mask)
            info.update(trainable=tr, reduction=1.0 - tr / max(tot, 1))
        self._record("finetune", t0, info)
        return dict(info, history=history)

    # ---- evaluation ----

    @torch.no_grad()
    def evaluate(self, params=None, *, num_batches: int = 8, seq_len: int = 32,
                 batch_size: int = 16, seed: int = 0, loss_fn: Callable | None = None,
                 batch_fn: Callable | None = None) -> float:
        """Held-out metric, higher = better: mean accuracy for classification
        configs, negative mean loss for LMs, over batches 1000.. of the
        stream.  Evaluates the session's params unless a tree is passed."""
        params = self.params if params is None else params
        loss_fn = loss_fn or self._default_loss_fn()
        batch_fn = batch_fn or self._default_batch_fn(seq_len, batch_size, seed)
        vals = []
        for i in range(1000, 1000 + num_batches):
            m = loss_fn(params, self._to_device(batch_fn(i)))[1]
            vals.append(float(m["acc"]) if "acc" in m else -float(m["loss"]))
        return float(np.mean(vals))

    # ---- squeeze ----

    def squeeze(self, *, delta: float = 0.05, max_iters: int = 8, step: int = 1,
                min_bond: int = 1, finetune_steps: int = 12, lr: float = 1e-3,
                mode: str = "lfa", seq_len: int = 32, batch_size: int = 16, seed: int = 0,
                eval_fn: Callable | None = None, loss_fn: Callable | None = None,
                batch_fn: Callable | None = None, weight_cache: bool = True,
                ckpt_dir: str | None = None, verbose: bool = False) -> list:
        """Dimension squeezing (paper Algorithm 2): repeatedly truncate the
        least-error bond, re-tune the auxiliary tensors for
        ``finetune_steps`` steps, stop when the metric gap exceeds
        ``delta``.  Every evaluation runs on a freshly contracted weight
        snapshot (``weight_cache=True``); the accepted tree is installed
        when the loop ends (``Model.set_tree``, bonds changed) and any
        serving snapshot taken before is invalidated.  Each event's
        ``seconds`` splits its iteration into spectra, tt_round, retune and
        eval.  ``ckpt_dir`` journals every ACCEPTED iteration (params,
        history and the stop rule's baseline metric,
        ``resilience.SqueezeJournal``): a preempted run re-invoked with the
        same ``ckpt_dir`` installs the journaled tree and resumes at the
        last completed iteration, reproducing the uninterrupted run's
        history and tree bit for bit.  The ``ssm`` family's re-tunes run
        the SSD scan's backward kernel as ``finetune`` does."""
        _refuse_expert_stacks(self.cfg, "Session.squeeze", squeeze_mod.EXPERT_STACKS)
        t0 = time.perf_counter()
        loss_fn = loss_fn or self._default_loss_fn()
        batch_fn = batch_fn or self._default_batch_fn(seq_len, batch_size, seed)
        if eval_fn is None:
            eval_fn = lambda p: self.evaluate(p, loss_fn=loss_fn, batch_fn=batch_fn)
        journal, start_iter, init_hist, baseline = None, 0, None, None
        if ckpt_dir:
            from repro_torch.resilience.journal import SqueezeJournal  # lazy
            journal = SqueezeJournal(ckpt_dir)
            resumed = journal.load(self.params)
            if resumed is not None:
                tree, start_iter, init_hist, baseline = resumed
                self.model.set_tree(tree)
                self._bump()
        rho0 = squeeze_mod.model_compression_ratio(self.params)

        def finetune_fn(p):
            return self._tune_params(p, steps=finetune_steps, lr=lr, mode=mode,
                                     loss_fn=loss_fn, batch_fn=batch_fn)

        best, history = squeeze_mod.run_dimension_squeezing(
            self.params, finetune_fn, eval_fn, delta=delta, max_iters=max_iters, step=step,
            min_bond=min_bond, verbose=verbose,
            weight_cache=self.model.cache_weights if weight_cache else None,
            start_iter=start_iter, initial_history=init_hist, baseline_metric=baseline,
            on_iteration=journal.record if journal else None)
        self.model.set_tree(best)
        self._bump()
        self.squeeze_history.extend(history)
        self._record("squeeze", t0, {
            "events": len(history), "delta": delta, "rho_before": rho0,
            "rho_after": squeeze_mod.model_compression_ratio(self.params)})
        return history

    def _tune_params(self, params, *, steps: int, lr: float, mode: str,
                     loss_fn: Callable, batch_fn: Callable, batch_offset: int = 2000):
        """Short LFA re-tune of an explicit tree (the inner loop of
        Algorithm 2), no stage record, no version bump (the enclosing
        ``squeeze`` owns both).  The optimizer updates in place, so it
        trains a copy: the tree it was given, whose leaves the accepted tree
        shares, is never written."""
        if steps <= 0:
            return params
        params = lightweight.tree_map(lambda t: t.detach().clone(), params)
        mask = lightweight.trainable_mask(params, mode=mode)
        opt = optimizers.adamw(lr, weight_decay=0.0, mask=mask)
        step_fn = make_train_step(self.model, opt, loss_fn=loss_fn)
        state = TrainState(params, opt.init(params))
        for i in range(steps):
            state, _ = step_fn(state, self._to_device(batch_fn(batch_offset + i)))
        return state.params

    # ---- serve ----

    def serve(self, batch_size: int, max_len: int, *, weight_cache: bool = True,
              mesh=None, rules=None, paged: bool = False,
              page_size: int = 16) -> ServeHandle:
        """Serving handle for the CURRENT weights.  The one-time
        ``init_serve`` (KV cache + cached-W contraction) runs only when no
        handle exists for this (batch, max_len, weight_cache, mesh, rules,
        paged, page_size) at the current weights version; a cached handle is
        returned reset.

        ``mesh`` (a ``DeviceMesh``, ``launch.mesh.make_host_mesh``) places
        the serving snapshot and the cache on it by the logical-axis rules
        (``make_serve_steps(mesh=...)``; ``rules`` overrides
        ``parallel.sharding.make_rules(mesh)``); every rank runs the same
        calls and gets the same tokens.  Example::

            mesh = make_host_mesh(model=1)              # one card
            handle = session.serve(8, 256, paged=True, mesh=mesh)
        """
        if mesh is not None and self.axes is None:
            raise ValueError(
                "Session.serve(mesh=...) needs the logical-axis tree; this "
                "session was constructed without one (Session(cfg, model)) — "
                "build it via Session.init/from_dense, or pass axes to the "
                "constructor")
        t0 = time.perf_counter()
        rules_key = None if rules is None else tuple(sorted(rules.items()))
        key = (batch_size, max_len, weight_cache, mesh, rules_key, paged, page_size)
        h = self._serve.get(key)
        if h is not None:
            return h.reset()
        handle = ServeHandle(self.model, self.params, batch_size, max_len,
                             weight_cache=weight_cache, version=self._version,
                             mesh=mesh, rules=rules,
                             axes=self.axes if mesh is not None else None,
                             paged=paged, page_size=page_size)
        self._serve[key] = handle
        self._record("serve", t0, {"batch": batch_size, "max_len": max_len,
                                   "weight_cache": weight_cache, "paged": paged,
                                   "mesh": None if mesh is None else
                                   dict(zip(mesh.mesh_dim_names, mesh.shape)),
                                   "init_seconds": handle.init_seconds})
        return handle

    # ---- report ----

    def report(self) -> dict:
        """Where the session is, what each stage cost, the compression
        ratio rho (Eq. 5) over every factorized matrix, the stats of every
        ``ServePool`` the caller still holds (``serve_pools``), the
        autotuner's (``autotune``) once planning has consulted it, and the
        static analysis of the live trees (``analysis``:
        ``analysis.session_summary``; ``{"error": ...}`` if it raised)."""
        out: dict[str, Any] = {
            "arch": self.cfg.name,
            "task": self.task,
            "stage": self.stage,
            "weights_version": self._version,
            "compression_ratio": compression_ratio(self.params),
            "params_total": lightweight.count_params(self.params),
            "stages": [{"stage": r.stage, "seconds": round(r.seconds, 4), **r.info}
                       for r in self._records],
        }
        if self.mask is not None:
            tr, tot = lightweight.count_trainable(self.params, self.mask)
            out["trainable"] = tr
            out["trainable_reduction"] = 1.0 - tr / max(tot, 1)
        if self.conversion_report:
            errs = list(self.conversion_report.values())
            out["conversion_max_rel_err"] = max(errs)
            out["conversion_mean_rel_err"] = float(np.mean(errs))
        if self.squeeze_history:
            out["squeeze_events"] = len(self.squeeze_history)
        pools = [p for p in (ref() for ref in self._pools) if p is not None]
        if pools:
            # every still-alive ServePool this session built (weakly held;
            # stale-version pools included: their stats carry the version)
            out["serve_pools"] = [p.stats() for p in pools]
        tuner = autotune.get_tuner()
        if tuner.timing_runs or tuner.stats()["keys_resolved"]:
            # the measured tuner was consulted in this process: where its
            # verdicts live and what tuning this process paid for
            out["autotune"] = tuner.stats()
        # the static analysis over the LIVE trees (sharding placement at
        # the abstract mesh sweep, kernel budgets at the current core shapes:
        # bonds a squeeze truncated are re-checked).  Never allowed to break
        # a report.
        from repro_torch.analysis import session_summary    # lazy: report stays cheap
        try:
            out["analysis"] = session_summary(self.cfg, self.params, self.axes)
        except Exception as e:  # pragma: no cover - defensive
            out["analysis"] = {"error": f"{type(e).__name__}: {e}"}
        return out


# Eq. 5 rho over every factorized matrix, each layer of a stack its own
compression_ratio = squeeze_mod.model_compression_ratio
