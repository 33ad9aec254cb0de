"""``PoolRouter``: a health-checked fleet of ``ServePool`` replicas — the
port of ``repro.pipeline.router``.

A single ``ServePool`` degrades gracefully (quarantine, backpressure,
deadlines) but is still one failure domain: a wedged
or poisoned pool takes its whole tenant set down.  ``PoolRouter`` fronts N
replica pools — all built from the SAME weight snapshot, so any replica
serves any request token-identically — behind the pool's own surface
(``submit() / step() / run() / stats()``; ``traffic.replay`` drives a
router unchanged).  Four policies compose:

* **least-loaded routing** — a request goes to the healthy replica with
  the most effective free slots (``slots - live - pending - admitting``),
  ties broken by free KV pages (paged pools), then round-robin;
* **retry with backoff** — a request that FAILS on a replica
  (``FailReason.QUARANTINE`` / ``DEADLINE`` / ``ADMISSION`` / ``BUDGET``)
  is re-submitted to a *different* replica after a capped exponential
  backoff (it regenerates from scratch there — greedy decode makes the
  retried tokens identical to serial generation); after ``retry_limit``
  attempts the request fails with the LAST ``FailReason``;
* **circuit breaking** — ``breaker_failures`` consecutive failures on one
  replica, or a quarantine storm (``storm_threshold`` events inside
  ``storm_window_steps``), trips the replica's breaker:
  its in-flight tenants fail over to the rest of the fleet, the replica
  is REBUILT from the session's saved weights (``rebuild_fn`` —
  ``Session.serve_fleet`` wires it to ``Session.save/restore``), and the
  breaker walks ``open → (cooldown) → half-open`` where a synthetic
  canary probe must complete before the replica takes traffic again
  (``→ closed``); a failed canary re-trips it;
* **load shedding** — past ``shed_queue_depth`` outstanding requests the
  front door fails fast with the distinct terminal status ``"shed"``
  (``FailReason.SHED``) instead of queueing into a blown p99; a shed
  request never touches a pool (no slot, no pages, no prefill).

A kernel failure is a crash, not a fallback.  The reference degrades a
failed flash call to its gather path and trips a replica on a storm of such
fallbacks; the port's flash kernel has no fallback.  So an
``InjectedKernelError`` (the ``flash-raise`` chaos site) or a
``KernelLaunchError`` raised by a replica's ``pool.step()`` takes the
``kill-pool`` path: the replica trips as killed, its tenants fail over with
``FailReason.REPLICA``, it is rebuilt, and the exception's text is the trip
reason.  Every other exception propagates, and a sticky CUDA fault, which
poisons the process's CUDA context, cannot be recovered by a rebuild in the
same process.  The storm counts quarantines only.

Chaos hooks (``resilience.faults``): ``kill-pool:IDX:STEP`` crashes a
replica mid-replay (pool object dropped, tenants fail over, rebuild +
rejoin), ``trip-pool:IDX`` forces a breaker open, ``shed-storm:K`` sheds
the next K submissions.  All deterministic — the router chaos matrix in
``tests/test_torch_router.py`` holds it against the reference's.

Example::

    router = session.serve_fleet(replicas=3, slots=4, max_len=64,
                                 session_dir="runs/fleet")
    for p in prompts:
        router.submit(p, max_new_tokens=16)
    outputs = router.run()              # {rid: token ids}
    print(router.stats()["trips"])
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.kernels._build import KernelLaunchError
from repro_torch.pipeline.clock import WallClock
from repro_torch.pipeline.scheduler import FailReason
from repro_torch.resilience import faults

__all__ = ["PoolRouter", "FleetRequest"]

# breaker states (+ "dead": killed with no rebuild_fn — never rejoins)
CLOSED, OPEN, HALF_OPEN, DEAD = "closed", "open", "half_open", "dead"

# pool-level failures the router retries on another replica; validation
# errors raise at submit and shed is terminal by design
RETRYABLE = (FailReason.QUARANTINE, FailReason.DEADLINE,
             FailReason.ADMISSION, FailReason.BUDGET, FailReason.REPLICA)

# errors a replica's pool.step() may raise that count as that replica's
# crash; anything else propagates
REPLICA_CRASHES = (faults.InjectedKernelError, KernelLaunchError)


class FleetRequest:
    """One request tracked by the router across replicas and retries.

    ``status`` walks ``queued -> routed -> done`` — or ``-> failed`` (last
    ``FailReason`` in ``error``) or ``-> shed`` (terminal at submit, never
    touched a pool).  ``attempts`` records each failed placement as
    ``{"replica", "reason", "detail"}``; ``tokens``/``output`` follow the
    CURRENT attempt while in flight and freeze at the terminal state."""

    def __init__(self, rid: int, prompt: np.ndarray, max_new_tokens: int,
                 eos_id: int | None, deadline_s: float | None,
                 submitted_at: float):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.deadline_s = deadline_s
        self.submitted_at = submitted_at
        self.status = "queued"       # queued | routed | done | failed | shed
        self.error: FailReason | None = None
        self.error_detail: str | None = None
        self.replica: int | None = None      # current placement
        self.retries = 0                     # budgeted retries consumed
        self.attempts: list[dict] = []       # failed placements
        self.not_before = 0.0                # backoff gate (clock time)
        self.exclude: int | None = None      # avoid this replica on reroute
        self._preq = None                    # live ServePool Request
        self._final: list | None = None      # tokens frozen at terminal

    @property
    def tokens(self) -> list:
        if self._final is not None:
            return self._final
        return list(self._preq.tokens) if self._preq is not None else []

    @property
    def output(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)

    @property
    def done(self) -> bool:
        return self.status == "done"


@dataclasses.dataclass
class _Replica:
    """Per-replica breaker state around one ``ServePool``."""

    idx: int
    pool: object
    state: str = CLOSED
    consecutive_failures: int = 0
    opened_at: float = 0.0
    canary_rid: int | None = None
    trips: int = 0
    rebuilds: int = 0
    # recent storm events (router step numbers): quarantines attributed
    # to this replica's decode steps
    storm: collections.deque = dataclasses.field(
        default_factory=collections.deque)
    rids: set = dataclasses.field(default_factory=set)  # routed FleetRequests


class PoolRouter:
    """Route/retry/trip/shed across ``ServePool`` replicas (module doc).

    ``pools`` must share geometry (slots, max_len, paged) and weights —
    ``Session.serve_fleet`` is the supported constructor.  ``rebuild_fn``
    returns a FRESH replacement pool (from the session's saved weights);
    without one a tripped/killed replica goes ``dead`` and never rejoins.
    Share ``clock`` with the pools and the replay loop."""

    def __init__(self, pools, *, rebuild_fn=None, clock=None,
                 retry_limit: int = 2, backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 1.0, breaker_failures: int = 3,
                 breaker_cooldown_s: float = 0.5, storm_threshold: int = 3,
                 storm_window_steps: int = 64,
                 shed_queue_depth: int | None = None,
                 canary_prompt=None, canary_tokens: int = 2):
        if not pools:
            raise ValueError("PoolRouter needs at least one replica pool")
        geo = {(p.slots, p.max_len, p.paged) for p in pools}
        if len(geo) > 1:
            raise ValueError(
                f"replica pools disagree on geometry {sorted(geo)}; a "
                "request must be servable by ANY replica")
        if retry_limit < 0:
            raise ValueError(f"retry_limit={retry_limit} must be >= 0")
        if breaker_failures < 1:
            raise ValueError(
                f"breaker_failures={breaker_failures} must be >= 1")
        if shed_queue_depth is not None and shed_queue_depth < 1:
            raise ValueError(
                f"shed_queue_depth={shed_queue_depth} must be >= 1")
        self._replicas = [_Replica(i, p) for i, p in enumerate(pools)]
        self._rebuild_fn = rebuild_fn
        self.clock = clock if clock is not None else getattr(
            pools[0], "clock", None) or WallClock()
        self.retry_limit = retry_limit
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.breaker_failures = breaker_failures
        self.breaker_cooldown_s = breaker_cooldown_s
        self.storm_threshold = storm_threshold
        self.storm_window_steps = storm_window_steps
        self.shed_queue_depth = shed_queue_depth
        self._canary_prompt = (np.asarray(canary_prompt, np.int32)
                               if canary_prompt is not None
                               else np.array([1, 2, 3], np.int32))
        self._canary_tokens = canary_tokens
        self._requests: dict[int, FleetRequest] = {}
        self._backlog: collections.deque[int] = collections.deque()
        self._open_rids: set[int] = set()    # non-terminal FleetRequests
        self._next_rid = 0
        self._steps = 0
        self._rr = 0                         # round-robin tiebreak cursor
        # ---- counters ----
        self._routed = 0                     # placements (incl. retries)
        self._retries = 0
        self._shed = 0
        self._trips = 0
        self._rebuilds = 0
        self._completed = 0
        self._failed = 0
        self._fail_reasons: collections.Counter = collections.Counter()

    # ---- submit ----

    def submit(self, prompt, max_new_tokens: int, eos_id: int | None = None,
               deadline_s: float | None = None) -> int:
        """Enqueue one request with the fleet; returns its router-level
        rid.  Impossible requests raise (same validation as the pool);
        past ``shed_queue_depth`` outstanding requests the submission is
        load-shed: terminal status ``"shed"`` immediately, no pool ever
        touched."""
        pool = self._any_usable_pool()
        prompt = pool.validate_request(prompt, max_new_tokens, deadline_s)
        rid = self._next_rid
        self._next_rid += 1
        req = FleetRequest(rid, prompt, max_new_tokens, eos_id, deadline_s,
                           self.clock.now())
        self._requests[rid] = req
        overloaded = (self.shed_queue_depth is not None
                      and len(self._open_rids) >= self.shed_queue_depth)
        if overloaded or faults.shed_request():
            req.status = "shed"
            req.error = FailReason.SHED
            req.error_detail = (
                f"load shed: {len(self._open_rids)} outstanding >= "
                f"shed_queue_depth ({self.shed_queue_depth})"
                if overloaded else "load shed: injected shed-storm")
            req._final = []
            self._shed += 1
            self._fail_reasons[FailReason.SHED.value] += 1
            return rid
        self._open_rids.add(rid)
        self._backlog.append(rid)
        self._dispatch()                     # route now if a replica is up
        return rid

    def request(self, rid: int) -> FleetRequest:
        """The tracked request (status/error/tokens) for ``rid``."""
        return self._requests[rid]

    # ---- routing ----

    def _any_usable_pool(self):
        for rep in self._replicas:
            if rep.state != DEAD:
                return rep.pool
        raise RuntimeError("every replica in the fleet is dead "
                           "(killed with no rebuild_fn)")

    def _score(self, rep: _Replica) -> tuple:
        pool = rep.pool
        free_slots = (pool.slots - pool.live - pool.pending
                      - (1 if pool.admitting else 0))
        free_pages = pool.free_pages
        return (free_slots, free_pages if free_pages is not None else 0)

    def _pick_replica(self, exclude: int | None) -> _Replica | None:
        """Least-loaded CLOSED replica; ``exclude`` is the replica a retry
        just failed on (honored unless it is the only one closed).  Ties
        break round-robin so equal-load replicas share admission work."""
        closed = [r for r in self._replicas if r.state == CLOSED]
        cands = [r for r in closed if r.idx != exclude] or closed
        if not cands:
            return None
        best = max(self._score(r) for r in cands)
        tied = {r.idx for r in cands if self._score(r) == best}
        n = len(self._replicas)
        for off in range(n):                 # first tied at/after cursor
            idx = (self._rr + off) % n
            if idx in tied:
                self._rr = (idx + 1) % n
                return self._replicas[idx]
        return None                          # unreachable

    def _route(self, req: FleetRequest, rep: _Replica):
        """Place ``req`` on ``rep``'s pool (the pool queues internally).
        An end-to-end deadline is forwarded as the REMAINING window."""
        deadline = None
        if req.deadline_s is not None:
            deadline = req.deadline_s - (self.clock.now() - req.submitted_at)
            if deadline <= 0:
                self._fail(req, FailReason.DEADLINE,
                           f"deadline ({req.deadline_s}s) expired in the "
                           "router backlog")
                return
        prid = rep.pool.submit(req.prompt, req.max_new_tokens,
                               eos_id=req.eos_id, deadline_s=deadline)
        req.replica = rep.idx
        req.status = "routed"
        req._preq = rep.pool.request(prid)
        rep.rids.add(req.rid)
        self._routed += 1

    def _dispatch(self):
        """Route every backlogged request whose backoff window has passed
        to the current least-loaded healthy replica."""
        if not self._backlog:
            return
        now = self.clock.now()
        keep: collections.deque[int] = collections.deque()
        while self._backlog:
            rid = self._backlog.popleft()
            req = self._requests[rid]
            if req.status not in ("queued",):
                continue
            if (req.deadline_s is not None
                    and now - req.submitted_at > req.deadline_s):
                self._fail(req, FailReason.DEADLINE,
                           f"deadline ({req.deadline_s}s) expired in the "
                           "router backlog")
                continue
            if req.not_before > now:
                keep.append(rid)
                continue
            rep = self._pick_replica(req.exclude)
            if rep is None:                  # nobody healthy right now
                keep.append(rid)
                continue
            self._route(req, rep)
        self._backlog = keep

    # ---- terminal bookkeeping ----

    def _fail(self, req: FleetRequest, reason: FailReason, detail: str):
        req.status = "failed"
        req.error = reason
        req.error_detail = detail
        req._final = req.tokens              # freeze the partial output
        req._preq = None
        self._failed += 1
        self._fail_reasons[reason.value] += 1
        self._open_rids.discard(req.rid)

    def _complete(self, req: FleetRequest):
        req.status = "done"
        req._final = req.tokens
        req._preq = None
        self._completed += 1
        self._open_rids.discard(req.rid)

    def _requeue(self, req: FleetRequest, rep: _Replica,
                 reason: FailReason, detail: str, *, backoff: bool):
        """Put a failed placement back in the backlog — with capped
        exponential backoff for the request's OWN failures, immediately
        for replica death/trip failover (not the request's fault, and the
        failover must not consume its retry budget)."""
        req.attempts.append({"replica": rep.idx, "reason": reason.value,
                             "detail": detail})
        req.exclude = rep.idx
        req.replica = None
        req._preq = None
        req.status = "queued"
        if backoff:
            req.retries += 1
            self._retries += 1
            req.not_before = self.clock.now() + min(
                self.backoff_cap_s,
                self.backoff_base_s * (2 ** (req.retries - 1)))
        else:
            req.not_before = self.clock.now()
        self._backlog.append(req.rid)

    # ---- circuit breaker ----

    def _trip(self, rep: _Replica, why: str, *, killed: bool = False):
        """Open ``rep``'s breaker: fail its tenants over to the rest of
        the fleet, rebuild the pool from the session's saved weights, and
        start the cooldown.  With no ``rebuild_fn`` the replica is dead
        (a crashed pool cannot be probed back to health)."""
        rep.trips += 1
        self._trips += 1
        rep.consecutive_failures = 0
        rep.storm.clear()
        rep.canary_rid = None
        for rid in sorted(rep.rids):         # failover, deterministic order
            req = self._requests[rid]
            if req.status != "routed":
                continue
            self._requeue(req, rep, FailReason.REPLICA,
                          f"replica {rep.idx} {why}; request rerouted",
                          backoff=False)
        rep.rids.clear()
        if self._rebuild_fn is None:
            rep.state = DEAD
            rep.pool = None if killed else rep.pool
            return
        rep.pool = self._rebuild_fn()
        rep.rebuilds += 1
        self._rebuilds += 1
        rep.state = OPEN
        rep.opened_at = self.clock.now()

    def _maybe_half_open(self, rep: _Replica):
        """Cooldown elapsed: probe the rebuilt pool with a synthetic
        canary request; traffic stays off until the canary completes."""
        if (rep.state == OPEN
                and self.clock.now() - rep.opened_at
                >= self.breaker_cooldown_s):
            rep.state = HALF_OPEN
            rep.canary_rid = rep.pool.submit(self._canary_prompt,
                                             self._canary_tokens)

    def _check_canary(self, rep: _Replica):
        canary = rep.pool.request(rep.canary_rid)
        if canary.done:
            rep.state = CLOSED               # healthy: take traffic again
            rep.canary_rid = None
        elif canary.status == "failed":
            self._trip(rep, f"canary probe failed ({canary.error})")

    def _note_storm_events(self, rep: _Replica, count: int):
        """Record ``count`` quarantines against ``rep`` at the current
        router step; trip on a storm."""
        if count <= 0 or rep.state != CLOSED:
            return
        rep.storm.extend([self._steps] * count)
        while rep.storm and rep.storm[0] <= self._steps - self.storm_window_steps:
            rep.storm.popleft()
        if len(rep.storm) >= self.storm_threshold:
            self._trip(rep, f"storm: {len(rep.storm)} quarantine "
                       f"events in {self.storm_window_steps} steps")

    # ---- step / harvest ----

    def _harvest(self, rep: _Replica):
        """Collect terminal pool requests routed to ``rep``; retryable
        failures go back to the backlog for a DIFFERENT replica."""
        quarantines = 0
        for rid in sorted(rep.rids):
            req = self._requests[rid]
            preq = req._preq
            if preq is None or preq.status not in ("done", "failed"):
                continue
            rep.rids.discard(rid)
            if preq.status == "done":
                rep.consecutive_failures = 0
                self._complete(req)
                continue
            rep.consecutive_failures += 1
            if preq.error is FailReason.QUARANTINE:
                quarantines += 1
            if (preq.error in RETRYABLE and req.retries < self.retry_limit
                    and len(self._replicas) > 1):
                self._requeue(req, rep, preq.error, preq.error_detail,
                              backoff=True)
            else:
                self._fail(req, preq.error, preq.error_detail)
        if rep.state == CLOSED and rep.consecutive_failures >= self.breaker_failures:
            self._trip(rep, f"{rep.consecutive_failures} consecutive "
                       "failures")
            return
        self._note_storm_events(rep, quarantines)

    def _pool_step(self, rep: _Replica) -> int | None:
        """``rep.pool.step()``; a kernel error (``REPLICA_CRASHES``) trips
        the replica as killed, with the error's text as the reason, and
        gives ``None``."""
        try:
            return rep.pool.step()
        except REPLICA_CRASHES as e:
            self._trip(rep, f"crashed: {type(e).__name__}: {e}", killed=True)
            return None

    def step(self) -> int:
        """One router turn: apply due chaos, walk breaker states, dispatch
        the backlog, run ONE ``pool.step()`` on every serving replica, and
        harvest completions/failures (retryable failures re-enter the
        backlog for another replica).  Returns the number of live slots
        that advanced across the fleet (canaries included)."""
        kill = faults.pool_kill_due(self._steps)
        if kill is not None and 0 <= kill < len(self._replicas) \
                and self._replicas[kill].state in (CLOSED, HALF_OPEN):
            self._trip(self._replicas[kill], "killed by chaos plan",
                       killed=True)
        trip = faults.pool_trip_due()
        if trip is not None and 0 <= trip < len(self._replicas) \
                and self._replicas[trip].state == CLOSED:
            self._trip(self._replicas[trip], "tripped by chaos plan")
        for rep in self._replicas:
            self._maybe_half_open(rep)
        self._dispatch()
        advanced = 0
        for rep in self._replicas:
            if rep.state not in (CLOSED, HALF_OPEN):
                continue
            closed = rep.state == CLOSED
            n = self._pool_step(rep)
            if n is None:                    # crashed: tripped and rebuilt
                continue
            advanced += n
            if closed:
                self._harvest(rep)
            else:
                self._check_canary(rep)
        self._steps += 1
        return advanced

    def run(self, budget_s: float | None = None,
            max_steps: int | None = None) -> dict[int, np.ndarray]:
        """Drain the fleet: step until every submitted request reached a
        terminal state.  Returns {rid: generated ids} for completed
        requests; failures/sheds are on ``request(rid)`` / ``stats()``.
        ``budget_s`` bounds the drain on the shared clock;  ``max_steps``
        is a safety valve (raise rather than loop forever)."""
        t0 = self.clock.now()
        steps = 0
        while self._open_rids:
            if budget_s is not None and self.clock.now() - t0 > budget_s:
                for rid in sorted(self._open_rids):
                    req = self._requests[rid]
                    self._fail(req, FailReason.BUDGET,
                               f"fleet budget ({budget_s}s) exhausted "
                               f"after {len(req.tokens)} tokens")
                self._backlog.clear()
                break
            if all(r.state == DEAD for r in self._replicas):
                for rid in sorted(self._open_rids):
                    self._fail(self._requests[rid], FailReason.REPLICA,
                               "every replica is dead; no rebuild_fn")
                break
            advanced = self.step()
            self.clock.on_step(advanced)
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(
                    f"router run exceeded max_steps={max_steps} with "
                    f"{len(self._open_rids)} open requests")
        return {rid: r.output for rid, r in self._requests.items()
                if r.done}

    # ---- replay-surface compatibility ----

    @property
    def live(self) -> int:
        """Occupied slots across serving replicas."""
        return sum(r.pool.live for r in self._replicas
                   if r.state in (CLOSED, HALF_OPEN))

    @property
    def pending(self) -> int:
        """Backlogged here + queued inside replica pools."""
        return len(self._backlog) + sum(
            r.pool.pending for r in self._replicas
            if r.state in (CLOSED, HALF_OPEN))

    @property
    def admitting(self) -> bool:
        """Any replica mid-admission, or any breaker mid-recovery (the
        replay loop must keep stepping so cooldowns/canaries make
        progress instead of fast-forwarding past them)."""
        return any(
            (r.state in (CLOSED, HALF_OPEN) and r.pool.admitting)
            or r.state in (OPEN, HALF_OPEN) for r in self._replicas)

    # ---- reporting ----

    def stats(self) -> dict:
        """Fleet counters + per-replica breaker state and pool stats.
        ``fail_reasons`` counts TERMINAL router outcomes (a retried-then-
        completed request does not count; per-pool attempt counts live in
        each replica's own ``fail_reasons``)."""
        return {
            "replicas": [
                {"idx": rep.idx, "state": rep.state, "trips": rep.trips,
                 "rebuilds": rep.rebuilds,
                 "consecutive_failures": rep.consecutive_failures,
                 "pool": None if rep.pool is None else rep.pool.stats()}
                for rep in self._replicas],
            "submitted": self._next_rid,
            "completed": self._completed,
            "failed": self._failed,
            "shed": self._shed,
            "fail_reasons": dict(self._fail_reasons),
            "routed": self._routed,
            "retries": self._retries,
            "trips": self._trips,
            "rebuilds": self._rebuilds,
            "outstanding": len(self._open_rids),
            "backlog": len(self._backlog),
            "steps": self._steps,
        }
