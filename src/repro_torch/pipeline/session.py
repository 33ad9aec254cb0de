"""``Session``: the stage-based lifecycle API — the port of
``repro.pipeline.session``, serving stage.

    Session.init(cfg, device=...)   fresh MPO-parameterized model
        │
        ▼
    .serve(batch, max_len)          one-time init_serve (KV cache + cached-W
        │                           contraction) -> prefill/decode handle
        ▼
    .report()                       compression ratio, params, stage timings

Conversion, fine-tuning and squeezing (``from_dense``, ``finetune``,
``squeeze``), the serving pool and fleet, and persistence come with later
slices of the port; those entry points raise ``NotImplementedError`` naming
their ``ROADMAP.md`` item.  The session's device is the card unless the
caller passes ``device="cpu"``; there is no silent move to the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.core import layers as L
from repro_torch.core import lightweight
from repro_torch.core.engine import engine_for
from repro_torch.models import model as M
from repro_torch.train.steps import make_serve_steps

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
        _not_yet("Session.from_dense (Algorithm 1 conversion)", "item 6")

    def finetune(self, *args, **kwargs):
        _not_yet("Session.finetune (lightweight fine-tuning)", "item 5")

    def squeeze(self, *args, **kwargs):
        _not_yet("Session.squeeze (Algorithm 2)", "item 6")

    def serve_pool(self, *args, **kwargs):
        _not_yet("Session.serve_pool", "item 9")

    def serve_fleet(self, *args, **kwargs):
        _not_yet("Session.serve_fleet", "item 9")

    def save(self, *args, **kwargs):
        _not_yet("Session.save", "item 8")

    @classmethod
    def restore(cls, *args, **kwargs):
        _not_yet("Session.restore", "item 8")

    # ---- bookkeeping ----

    def _record(self, stage: str, t0: float, info: dict):
        self.stage = stage
        self._records.append(StageRecord(stage, time.perf_counter() - t0, info))

    @property
    def weights_version(self) -> int:
        return self._version

    @property
    def task(self) -> str:
        return "cls" if self.cfg.num_classes else "lm"

    # ---- serve ----

    def serve(self, batch_size: int, max_len: int, *, weight_cache: bool = True,
              mesh=None, paged: bool = False, page_size: int = 16) -> ServeHandle:
        """Serving handle for the CURRENT weights.  The one-time
        ``init_serve`` (KV cache + cached-W contraction) runs only when no
        handle exists for this (batch, max_len, weight_cache, paged,
        page_size) at the current weights version; a cached handle is
        returned reset."""
        if mesh is not None:
            _not_yet("Session.serve(mesh=...)", "item 13")
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
