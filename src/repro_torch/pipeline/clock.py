"""Shared clock protocol for serving-time scheduling.

Everything in the serving stack that reasons about time — ``ServePool``
deadlines/budgets, ``PoolRouter`` retry backoff and breaker cooldowns,
``traffic.replay`` arrival schedules — takes a ``clock=`` implementing
three methods:

* ``now() -> float`` — seconds since the clock's epoch;
* ``on_step(advanced: int)`` — called once per scheduler step by whoever
  DRIVES the loop (``ServePool.run``, ``PoolRouter.run``,
  ``traffic.replay``); a no-op for real time, the tick for virtual time;
* ``advance_past(t: float)`` — idle until time ``t`` (sleep vs jump).

``WallClock`` measures real latency (benchmarks, production).
``VirtualClock`` charges a fixed virtual cost per step, making every
time-dependent behavior — deadline expiry, ``run(budget_s=)``, router
backoff windows, breaker cooldowns — a pure function of the step
schedule: tests assert exact expiry points instead of sleeping.

Share ONE clock instance across the pools, the router, and the replay
loop driving them; with multiple independent clocks, "now" disagrees
between the component that stamps ``submitted_at`` and the one that
checks the deadline.
"""

from __future__ import annotations

import time

__all__ = ["WallClock", "VirtualClock"]


class WallClock:
    """Real time, zeroed at construction — latency in actual seconds."""

    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def on_step(self, advanced: int) -> None:
        pass                         # real time passes on its own

    def advance_past(self, t: float) -> None:
        """Idle until trace time ``t`` (pool fully drained, next arrival
        in the future)."""
        time.sleep(max(0.0, t - self.now()))


class VirtualClock:
    """Deterministic clock for tests: every pool step costs ``step_s``
    virtual seconds, idling jumps straight to the next arrival.  Replay
    latencies become pure functions of the schedule — no timing flake."""

    def __init__(self, step_s: float = 0.01):
        if step_s <= 0:
            raise ValueError(f"step_s={step_s} must be positive")
        self.step_s = step_s
        self._t = 0.0

    def now(self) -> float:
        return self._t

    def on_step(self, advanced: int) -> None:
        self._t += self.step_s

    def advance_past(self, t: float) -> None:
        self._t = max(self._t, t)
