"""Iteration-level journal for dimension squeezing (Algorithm 2) — the port
of ``repro.resilience.journal``.

A squeeze run is the longest single stage of the lifecycle: every iteration
pays the bond spectra, a truncation, a short fine-tune and a full
evaluation.  The journal checkpoints each ACCEPTED iteration (params after
the truncate+re-tune, the history so far, and the baseline metric the stop
rule compares against) through ``checkpoint.CheckpointManager`` — so it
inherits the atomic step-dir + ``latest``-symlink durability contract — and
a preempted run resumes at the last completed iteration instead of
restarting from scratch.

Every ingredient of an iteration is deterministic (the synthetic batch
streams are indexed by step, the truncation is SVD-based, the kernels have
no atomics), so a resumed run reproduces the uninterrupted run's history
and final params exactly; ``tests/test_torch_persistence.py`` and
``chip_smoke.py``'s ``persistence`` phase assert it bit for bit.

The records are the reference's, plus each event's ``seconds``, which
``event_from_json`` defaults to ``{}``: either package resumes the other's
journal.  Used by ``Session.squeeze(ckpt_dir=...)``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.squeeze import SqueezeEvent


def event_to_json(e: SqueezeEvent) -> dict:
    d = dataclasses.asdict(e)
    d["layer"] = list(d["layer"])  # tuples don't survive JSON
    return d


def event_from_json(d: dict) -> SqueezeEvent:
    return SqueezeEvent(step=int(d["step"]), layer=tuple(d["layer"]),
                        bond=int(d["bond"]), new_dim=int(d["new_dim"]),
                        predicted_error=float(d["predicted_error"]),
                        metric=float(d["metric"]),
                        seconds=dict(d.get("seconds", {})))


class SqueezeJournal:
    """Persist/restore Algorithm 2 progress, one record per accepted
    iteration.  ``record`` is handed to ``run_dimension_squeezing`` as its
    ``on_iteration`` callback; ``load`` answers "where did the last run
    get to?" before starting."""

    def __init__(self, directory: str):
        # journal writes block: an iteration takes seconds, the write less,
        # and synchronous publication keeps "journaled" == "durable" (no
        # async window where a preemption loses the record)
        self._mgr = CheckpointManager(directory, keep=2, async_save=False)

    def load(self, template, device=None):
        """(params, next_iter, history, baseline_metric) from the last
        accepted iteration, or ``None`` for a fresh/empty journal.
        ``template`` supplies the tree structure, dtypes and (unless
        ``device`` is given) the device; bond truncation changes leaf
        SHAPES, which come from the arrays."""
        step = self._mgr.latest_step()
        if step is None:
            return None
        params, meta = self._mgr.restore(step, template, device=device)
        history = [event_from_json(e) for e in meta["history"]]
        return params, int(meta["next_iter"]), history, float(meta["baseline_metric"])

    def record(self, it: int, params, history, baseline_metric: float):
        """Journal accepted iteration ``it`` (durable before return)."""
        self._mgr.save(it + 1, params, extra_meta={
            "next_iter": it + 1,
            "history": [event_to_json(e) for e in history],
            "baseline_metric": float(baseline_metric),
        }, block=True)
