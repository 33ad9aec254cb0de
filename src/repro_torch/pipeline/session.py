"""``Session``: the stage-based lifecycle API — the port of
``repro.pipeline.session``, fine-tuning and serving stages.

    Session.init(cfg, device=...)   fresh MPO-parameterized model
        │
        ▼
    .finetune(mode="lfa")           trainability mask + masked optimizer +
        │                           train loop (auxiliary tensors only)
        ▼
    .serve(batch, max_len)          one-time init_serve (KV cache + cached-W
        │                           contraction) -> prefill/decode handle
        ▼
    .report()                       compression ratio, trainable reduction,
                                    stage timings

A densified weight-cache snapshot is only valid for the cores it was taken
from: ``finetune`` bumps the weights version, so a later ``serve``
re-densifies from the tuned cores.  Conversion and squeezing
(``from_dense``, ``squeeze``), the serving pool and fleet, and persistence
come with later slices of the port; those entry points raise
``NotImplementedError`` naming their ``ROADMAP.md`` item.  The session's
device is the card unless the caller passes ``device="cpu"``; there is no
silent move to the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import layers as L
from repro_torch.core import lightweight
from repro_torch.core.engine import engine_for
from repro_torch.data.pipeline import SyntheticCLS, make_batch_fn
from repro_torch.models import model as M
from repro_torch.optim import optimizers, schedule
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
    taken ONCE at construction (KV-cache allocation + ``cache_weights``
    densification).  Carries the weights version it was built from so
    ``Session.serve`` can detect staleness.  The KV cache is updated in
    place; ``reset`` rewinds it to the empty state kept from construction.
    Example::

        handle = session.serve(batch_size=8, max_len=64)
        out = handle.generate({"tokens": prompts}, num_tokens=16)  # (8, 16)
    """

    def __init__(self, model: M.Model, params, batch_size: int, max_len: int, *,
                 weight_cache: bool = True, version: int = 0, paged: bool = False,
                 page_size: int = 16):
        self.batch_size, self.max_len = batch_size, max_len
        self.weight_cache = weight_cache
        self.version = version
        self.paged = paged
        self.device = model.device
        self._prefill, self._decode, self._init_serve = make_serve_steps(
            model, weight_cache=weight_cache, paged=paged, page_size=page_size)
        t0 = time.perf_counter()
        with torch.no_grad():
            self.params, self._cache0 = self._init_serve(params, batch_size, max_len)
        self.cache = {k: v.clone() for k, v in self._cache0.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.init_seconds = time.perf_counter() - t0

    @torch.no_grad()
    def reset(self) -> "ServeHandle":
        """Rewind the (in-place updated) KV cache to its empty initial state."""
        for k, v in self._cache0.items():
            self.cache[k].copy_(v)
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


def _not_yet(what: str, item: str):
    raise NotImplementedError(f"{what} comes with ROADMAP.md, Queue 1 {item}")


class Session:
    """Owns the model, its params, the ``MPOEngine`` and weight-cache
    validity.  Example::

        from repro_torch import Session
        s = Session.init("bert-base", smoke=False)        # on the card
        out = s.serve(8, 256, paged=True).generate(batch, num_tokens=32)
        print(s.report())
    """

    def __init__(self, cfg: ModelConfig, model: M.Model):
        self.cfg = cfg
        self.model = model
        self.engine = engine_for(cfg.mpo)
        self.stage = "init"
        self._records: list[StageRecord] = []
        self._version = 0                 # bumped on every core mutation
        # (batch, max_len, weight_cache, paged, page_size) -> ServeHandle at
        # _version; cleared on every bump so a stale snapshot is never reused
        self._serve: dict[tuple, ServeHandle] = {}
        self.mask = None                  # last trainability mask
        self._loss_default: Callable | None = None

    @property
    def params(self) -> dict:
        return self.model.tree()

    @property
    def device(self) -> torch.device:
        return self.model.device

    # ---- constructors ----

    @classmethod
    def init(cls, cfg: ModelConfig | str, *, seed: int = 0, smoke: bool = True,
             device=None, **overrides) -> "Session":
        """Fresh MPO-parameterized model on ``device`` (the card when None;
        raises if there is none).  ``cfg`` may be a ``ModelConfig`` or an arch
        name (``smoke=True`` scales it down to the CPU-sized config the tests
        use); ``overrides`` replace config fields either way."""
        if isinstance(cfg, str):
            cfg = (configs.smoke_config(cfg, **overrides) if smoke
                   else configs.get_config(cfg, **overrides))
        elif overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        t0 = time.perf_counter()
        model = M.build(cfg, seed=seed, device=device)
        s = cls(cfg, model)
        s._record("init", t0, {"params": lightweight.count_params(s.params)})
        return s

    @classmethod
    def from_dense(cls, *args, **kwargs):
        _not_yet("Session.from_dense (Algorithm 1 conversion)", "item 2")

    def squeeze(self, *args, **kwargs):
        _not_yet("Session.squeeze (Algorithm 2)", "item 2")

    def serve_pool(self, *args, **kwargs):
        _not_yet("Session.serve_pool", "item 4")

    def serve_fleet(self, *args, **kwargs):
        _not_yet("Session.serve_fleet", "item 4")

    def save(self, *args, **kwargs):
        _not_yet("Session.save", "item 3")

    @classmethod
    def restore(cls, *args, **kwargs):
        _not_yet("Session.restore", "item 3")

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
                 log_every: int = 50, donate: bool = False,
                 verbose: bool = False) -> dict:
        """Lightweight fine-tuning (paper §4.1): the trainability mask
        (``mode="lfa"`` freezes the central tensors), a masked AdamW (frozen
        leaves allocate no state and receive no updates), and the train
        loop.  Every MPO matmul of the step runs through the engine's
        ``train``-phase plan — on the card the fused MPO-linear kernels,
        forward and backward.  The parameters update in place, so ``donate``
        has nothing to do and is accepted for the reference's signature;
        ``ckpt_dir`` comes with persistence (ROADMAP.md, Queue 1 item 3).
        Returns a stage report with the loss history."""
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
        loop = LoopConfig(steps=steps, ckpt_dir=ckpt_dir,
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

    # ---- serve ----

    def serve(self, batch_size: int, max_len: int, *, weight_cache: bool = True,
              mesh=None, paged: bool = False, page_size: int = 16) -> ServeHandle:
        """Serving handle for the CURRENT weights.  The one-time
        ``init_serve`` (KV cache + cached-W contraction) runs only when no
        handle exists for this (batch, max_len, weight_cache, paged,
        page_size) at the current weights version; a cached handle is
        returned reset."""
        if mesh is not None:
            _not_yet("Session.serve(mesh=...)", "item 8")
        t0 = time.perf_counter()
        key = (batch_size, max_len, weight_cache, paged, page_size)
        h = self._serve.get(key)
        if h is not None:
            return h.reset()
        handle = ServeHandle(self.model, self.params, batch_size, max_len,
                             weight_cache=weight_cache, version=self._version,
                             paged=paged, page_size=page_size)
        self._serve[key] = handle
        self._record("serve", t0, {"batch": batch_size, "max_len": max_len,
                                   "weight_cache": weight_cache, "paged": paged,
                                   "init_seconds": handle.init_seconds})
        return handle

    # ---- report ----

    def report(self) -> dict:
        """Where the session is, what each stage cost, and the compression
        ratio rho (Eq. 5) over every factorized matrix."""
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
        return out


def compression_ratio(params) -> float:
    """Aggregate Eq. 5 rho: core parameters over the dense parameters of the
    same matrices, each stacked layer counted as its own matrix."""
    num = den = 0

    def visit(node):
        nonlocal num, den
        if not isinstance(node, dict):
            return
        if "cores" in node:
            cores = L.cores_to_list(node["cores"])
            stack = cores[0].shape[:-4].numel()
            num += sum(c.numel() for c in cores)
            den += stack * (torch.Size(c.shape[-3] for c in cores).numel()
                            * torch.Size(c.shape[-2] for c in cores).numel())
            return
        for v in node.values():
            visit(v)

    visit(params)
    return num / max(den, 1)
