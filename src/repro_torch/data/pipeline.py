"""Deterministic synthetic data pipelines — the port's copy of
``repro.data.pipeline`` (numpy only, so the port keeps its own copy).

Every batch is a pure function of ``(seed, step, shard)`` — no iterator
state — and the numpy streams are the reference's, so both packages see the
same batches bit for bit.  Batches are numpy dicts; the train loop moves them
to the model's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig

IGNORE = -100      # label value the losses skip (``train.steps.IGNORE``)


@dataclasses.dataclass
class SyntheticLM:
    """Token chains from a fixed random branching process (learnable)."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branch: int = 4

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab, 4096)  # active vocab kept small -> fast learning
        self.active = v
        self.trans = rng.integers(0, v, size=(v, self.branch)).astype(np.int32)

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        """The GLOBAL batch is a pure function of (seed, step); each shard
        takes its contiguous slice."""
        assert self.global_batch % num_shards == 0
        per = self.global_batch // num_shards
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        b, s = self.global_batch, self.seq_len
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.integers(0, self.active, size=b)
        picks = rng.integers(0, self.branch, size=(b, s))
        for t in range(1, s):
            toks[:, t] = self.trans[toks[:, t - 1], picks[:, t]]
        sl = slice(shard * per, (shard + 1) * per)
        return {"tokens": toks[sl], "labels": toks[sl].copy()}


@dataclasses.dataclass
class SyntheticCLS:
    """GLUE-analog classification: label = which marker token dominates."""

    vocab: int
    seq_len: int
    global_batch: int
    num_classes: int = 2
    seed: int = 0

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        per = self.global_batch // num_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed + 77, step]))
        v = min(self.vocab, 1024)
        b = self.global_batch
        toks = rng.integers(8, v, size=(b, self.seq_len)).astype(np.int32)
        labels = rng.integers(0, self.num_classes, size=b).astype(np.int32)
        # plant a class-dependent marker pattern (tokens 1..num_classes)
        n_mark = self.seq_len // 8
        for i in range(b):
            pos = rng.choice(self.seq_len - 1, size=n_mark, replace=False) + 1
            toks[i, pos] = 1 + labels[i]
        toks[:, 0] = 0  # CLS
        sl = slice(shard * per, (shard + 1) * per)
        return {"tokens": toks[sl], "labels": labels[sl]}


def frontend_input(cfg: ModelConfig) -> tuple[str, int] | None:
    """The batch key and feature width of the family's non-token input:
    ``("patches", frontend_dim)`` for ``vlm`` (ahead of the text),
    ``("frames", d_model)`` for ``encdec`` (the encoder's stub frame
    embeddings), else None; ``frontend_len`` of them a row."""
    return {"vlm": ("patches", cfg.frontend_dim),
            "encdec": ("frames", cfg.d_model)}.get(cfg.family)


def make_batch_fn(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0):
    """Batch function ``step -> numpy batch dict``.  A ``vlm`` batch adds
    ``patches`` and an ``encdec`` batch ``frames`` (``frontend_input``),
    drawn once from the seed, the same every step.  A ``vlm`` ``seq_len``
    counts the patches: the text takes ``seq_len - frontend_len`` tokens
    and the labels are IGNORE over the patches; an ``encdec`` ``seq_len``
    is the decoder's tokens alone."""
    text = shape.seq_len - (cfg.frontend_len if cfg.family == "vlm" else 0)
    lm = SyntheticLM(cfg.vocab_size, text, shape.global_batch, seed=seed)
    frontend = frontend_input(cfg)
    if frontend is not None:
        static = np.random.default_rng(seed + 1234).normal(
            0, 1, size=(shape.global_batch, cfg.frontend_len, frontend[1])).astype(np.float32)

    def fn(step: int, shard: int = 0, num_shards: int = 1) -> dict:
        b = lm.batch(step, shard, num_shards)
        per = shape.global_batch // num_shards
        if frontend is not None:
            b[frontend[0]] = static[shard * per:(shard + 1) * per]
        if cfg.family == "vlm":
            pad = np.full((per, cfg.frontend_len), IGNORE, np.int32)
            b["labels"] = np.concatenate([pad, b["labels"]], axis=1)
        return b

    return fn
