"""Open-loop traffic replay against a ``ServePool`` — the port of
``repro.pipeline.traffic`` (numpy only: ``make_trace`` gives the
reference's trace for the same seed, byte for byte).

Closed-loop harnesses (``ServePool.run()``: submit everything, drain) hide
queueing behavior — completions gate arrivals, so the pool never sees the
backlog a real front door builds up.  This module replays an OPEN-LOOP
trace: requests arrive on their own (Poisson) schedule whether or not the
pool kept up, which is the regime where admission stalls (a long
prompt's whole prefill in one step) surface as p99 latency.

Three pieces:

* ``make_trace(n, rate_rps, seed=...)`` — a seeded, deterministic list of
  ``TrafficRequest`` with exponential inter-arrival gaps (Poisson process)
  and per-request prompt length / token budget drawn from given ranges.
  Same seed, same trace — byte-for-byte.
* ``replay(pool, trace, clock=...)`` — feeds the trace into the pool:
  submits every request whose arrival time has passed, runs ONE
  ``pool.step()`` per loop turn, and timestamps each request's first token
  (TTFT) and completion.  Arrivals are never gated on completions.  The
  "pool" may equally be a ``pipeline.router.PoolRouter`` fleet — it
  exposes the same surface, and the summary then carries the fleet's
  ``shed``/``retries``/``trips``/``rebuilds`` counters.
* clocks — ``WallClock``/``VirtualClock`` live in ``pipeline.clock``
  (re-exported here): wall time for real latency (benchmarks), a fixed
  virtual cost per pool step for deterministic tests (no timing flake).
  Pass the SAME clock instance to the pool/fleet (``serve_pool(clock=)``)
  and to ``replay`` so deadlines and arrival times agree.

Example::

    trace = make_trace(200, rate_rps=20.0, seed=7)
    pool = session.serve_pool(slots=4, max_len=64,
                              prefill_chunk=8, bucket_prompts=True)
    report = replay(pool, trace)
    print(report.summary["p99_latency_s"], report.summary["tok_s"])
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.pipeline.clock import VirtualClock, WallClock

__all__ = ["TrafficRequest", "make_trace", "replay", "ReplayReport",
           "WallClock", "VirtualClock"]


@dataclasses.dataclass(frozen=True)
class TrafficRequest:
    """One arrival in an open-loop trace: WHEN it shows up (seconds from
    trace start) and what it asks for (mirrors ``ServePool.submit``)."""

    at_s: float
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: int | None = None
    deadline_s: float | None = None


def make_trace(n: int, rate_rps: float, *, seed: int = 0,
               prompt_len: tuple[int, int] = (4, 24),
               max_new: tuple[int, int] = (1, 16),
               vocab_size: int = 1000, eos_id: int | None = None,
               deadline_s: float | None = None) -> list[TrafficRequest]:
    """A seeded Poisson arrival trace: ``n`` requests at ``rate_rps``
    offered load (exponential gaps, so bursts happen), prompt lengths and
    token budgets uniform over the inclusive ranges.  Deterministic in
    ``seed`` — replaying the same trace twice submits identical requests
    at identical offsets."""
    if n < 1:
        raise ValueError(f"n={n} must be >= 1")
    if rate_rps <= 0:
        raise ValueError(f"rate_rps={rate_rps} must be positive")
    rng = np.random.default_rng(seed)
    at = np.cumsum(rng.exponential(1.0 / rate_rps, size=n))
    out = []
    for i in range(n):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        budget = int(rng.integers(max_new[0], max_new[1] + 1))
        prompt = rng.integers(1, vocab_size, size=plen, dtype=np.int64)
        out.append(TrafficRequest(float(at[i]), prompt.astype(np.int32),
                                  budget, eos_id, deadline_s))
    return out


@dataclasses.dataclass
class ReplayReport:
    """Per-request records + aggregate summary from one ``replay``.

    Each record: ``rid``, ``at_s`` (scheduled arrival), ``first_s`` /
    ``done_s`` (first-token / terminal clock timestamps, ``None`` if never
    reached), ``status`` (``done`` | ``failed`` | ``shed``), ``tokens``
    (generated ids, np.int32).  ``summary`` holds the percentiles the
    benchmark plots."""

    records: list[dict]
    summary: dict


def _percentiles(xs: list[float]) -> tuple[float, float]:
    if not xs:
        return 0.0, 0.0
    arr = np.asarray(xs, np.float64)
    return float(np.percentile(arr, 50)), float(np.percentile(arr, 99))


def replay(pool, trace: list[TrafficRequest], *, clock=None,
           max_steps: int | None = None) -> ReplayReport:
    """Open-loop replay: submit each request at its ``at_s`` (arrivals
    NEVER wait for completions), one ``pool.step()`` per loop turn, until
    every request reached a terminal state.  ``max_steps`` is a safety
    valve for tests (raise past it rather than loop forever)."""
    clock = WallClock() if clock is None else clock
    pending = collections.deque(sorted(trace, key=lambda r: r.at_s))
    open_rids: dict[int, dict] = {}
    records: list[dict] = []
    steps = 0
    while pending or open_rids:
        now = clock.now()
        while pending and pending[0].at_s <= now:
            r = pending.popleft()
            rid = pool.submit(r.prompt, r.max_new_tokens, eos_id=r.eos_id,
                              deadline_s=r.deadline_s)
            rec = {"rid": rid, "at_s": r.at_s, "first_s": None,
                   "done_s": None, "status": None, "tokens": None}
            open_rids[rid] = rec
            records.append(rec)
        advanced = pool.step()
        clock.on_step(advanced)
        steps += 1
        now = clock.now()
        done = []
        for rid, rec in open_rids.items():
            req = pool.request(rid)
            if rec["first_s"] is None and len(req.tokens) > 0:
                rec["first_s"] = now
            if req.status in ("done", "failed", "shed"):
                rec["done_s"] = now
                rec["status"] = req.status
                rec["tokens"] = req.output
                done.append(rid)
        for rid in done:
            del open_rids[rid]
        if (advanced == 0 and not open_rids and pending
                and not pool.admitting and pool.pending == 0):
            clock.advance_past(pending[0].at_s)   # drained: idle to next
        if max_steps is not None and steps > max_steps:
            raise RuntimeError(
                f"replay exceeded max_steps={max_steps} with "
                f"{len(open_rids)} open + {len(pending)} pending requests")

    lat = [r["done_s"] - r["at_s"] for r in records if r["status"] == "done"]
    ttft = [r["first_s"] - r["at_s"] for r in records
            if r["first_s"] is not None]
    p50, p99 = _percentiles(lat)
    t50, t99 = _percentiles(ttft)
    gen = sum(len(r["tokens"]) for r in records if r["tokens"] is not None)
    makespan = clock.now() - (trace[0].at_s if trace else 0.0)
    summary = {
        "requests": len(records),
        "completed": sum(r["status"] == "done" for r in records),
        "failed": sum(r["status"] == "failed" for r in records),
        "shed": sum(r["status"] == "shed" for r in records),
        "steps": steps,
        "makespan_s": round(makespan, 4),
        "tokens_generated": gen,
        "tok_s": round(gen / makespan, 1) if makespan > 0 else 0.0,
        "p50_latency_s": round(p50, 4),
        "p99_latency_s": round(p99, 4),
        "p50_ttft_s": round(t50, 4),
        "p99_ttft_s": round(t99, 4),
    }
    st = pool.stats() if hasattr(pool, "stats") else {}
    if "retries" in st:                  # a PoolRouter fleet: its counters
        summary.update(retries=st["retries"], trips=st["trips"],
                       rebuilds=st["rebuilds"])
    return ReplayReport(records=records, summary=summary)
