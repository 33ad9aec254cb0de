"""Deterministic fault injection for lifecycle robustness tests — the port
of ``repro.resilience.faults``.

A ``FaultPlan`` names exactly WHERE and WHEN faults fire — "preempt the
fine-tune at step 12", "crash the checkpoint writer after the step dir is
published but before the ``latest`` symlink flips" — so a chaos test is as
reproducible as any other test: same plan, same run, same failure.

Instrumented sites (grep for the call to find the exact line):

===================  =====================================================
site                 instrumented in
===================  =====================================================
``finetune`` step    ``train.loop.run_training`` (top of every step)
``squeeze`` iter     ``core.squeeze.run_dimension_squeezing``
``ckpt:mid_write``   ``checkpoint.manager`` — tmp dir exists, arrays not
                     yet durable (a kill mid-``np.savez``)
``ckpt:pre_latest``  ``checkpoint.manager`` — ``step_<n>`` fully
                     published, ``latest`` symlink NOT yet flipped
``ckpt`` I/O         every file operation inside the checkpoint writer
                     (transient ``OSError``; the manager retries with
                     exponential backoff)
decode logits        ``pipeline.scheduler.ServePool.step`` — the chosen
                     slot's logits row becomes NaN before the guard runs
page admission       ``ServePool`` admission — reports the page pool as
                     exhausted for the first N attempts (backpressure)
admission chunk      ``ServePool`` chunked admission — expires the
                     in-flight request's deadline between prefill chunks
                     (the half-built batch-1 cache is dropped without
                     touching the pool page table)
flash kernel         ``kernels.decode_attention.flash_decode_attention``
                     — raises before dispatch, on the CPU and the card
                     alike, as a failed launch would
``kill-pool``        ``pipeline.router.PoolRouter.step`` — replica IDX
                     "crashes" at router step STEP: its in-flight tenants
                     fail over, the replica is rebuilt from the session
                     checkpoint (breaker open -> half-open -> closed)
``trip-pool``        ``PoolRouter.step`` — force replica IDX's circuit
                     breaker open (as a failure storm would)
``shed-storm``       ``PoolRouter.submit`` — the next K submissions are
                     load-shed at the front door (status ``shed``)
===================  =====================================================

``FaultPlan`` carries every field of the reference's plan and ``parse``
reads its whole grammar, so a ``--chaos`` spec means the same in both
packages.  The port's flash kernel has no fallback: where the reference
degrades a failed flash call to its gather path, the port's
``InjectedKernelError`` (like a real ``KernelLaunchError``) propagates out
of ``ServePool.step``, and ``PoolRouter`` counts it as that replica's crash.

Activate a plan with ``fault_scope``::

    from repro_torch.resilience import faults
    plan = faults.FaultPlan(preempt_squeeze_iter=2)
    with faults.fault_scope(plan):
        session.squeeze(..., ckpt_dir=jdir)   # raises faults.Preemption

The active plan is a plain module global — NOT thread-local — so faults
reach the checkpoint manager's background writer thread too.  Every check
is a no-op when no plan is active; production code pays one global read
per site.  The module needs nothing beyond the standard library (the NaN
site imports numpy when it fires).

``Preemption`` and ``CrashPoint`` derive from ``BaseException`` on
purpose: like a real SIGKILL they must sail through ``except Exception``
recovery code instead of being absorbed by it.
"""

from __future__ import annotations

import contextlib
import dataclasses


class FaultError(RuntimeError):
    """Base class for injected *recoverable* faults."""


class Preemption(BaseException):
    """Simulated preemption (SIGTERM at a chosen step/iteration)."""


class CrashPoint(BaseException):
    """Simulated hard kill at a named point inside a critical section."""


class InjectedIOError(OSError):
    """Simulated transient I/O failure (retryable)."""


class InjectedKernelError(FaultError):
    """Simulated kernel failure (raised where a launch would fail)."""


@dataclasses.dataclass
class FaultPlan:
    """One deterministic fault schedule.  All fields default to "no fault";
    counters (``io_errors``, ``deny_page_admissions``) are consumed by the
    run, so build a fresh plan per experiment."""

    # raise Preemption when the fine-tune loop reaches this step (0-based)
    preempt_finetune_step: int | None = None
    # raise Preemption when Algorithm 2 reaches this iteration (0-based)
    preempt_squeeze_iter: int | None = None
    # crash the checkpoint writer at a named point:
    # "mid_write" (tmp dir exists, arrays incomplete) or
    # "pre_latest" (step dir published, symlink not flipped)
    crash_ckpt: str | None = None
    crash_ckpt_step: int | None = None   # restrict to one step (else first)
    # {site: count} transient OSErrors; each check consumes one
    io_errors: dict = dataclasses.field(default_factory=dict)
    # ---- serving sites (pipeline.scheduler / pipeline.router) ----
    # NaN-poison one slot's logits at one pool decode step (0-based).
    # ONE-SHOT: consumed when it fires, so in a replicated fleet only the
    # first pool to reach the step is poisoned — the retry on a different
    # replica must see healthy logits.
    nan_decode_step: int | None = None
    nan_decode_slot: int = 0
    # report the page pool exhausted for the first N admission attempts
    deny_page_admissions: int = 0
    # expire the in-flight chunked admission's deadline after this many
    # prefill chunks landed (1-based: K=1 fires between chunk 1 and 2)
    expire_admit_chunk: int | None = None
    # flash decode-attention raises (as a failed launch would); not one-shot
    flash_raises: bool = False
    # crash replica IDX at router step STEP (one-shot): (IDX, STEP)
    kill_pool: tuple | None = None
    # force replica IDX's circuit breaker open (one-shot)
    trip_pool: int | None = None
    # load-shed the next K router submissions (consumed per submit)
    shed_storm: int = 0
    _crashed: bool = dataclasses.field(default=False, init=False, repr=False)

    @classmethod
    def parse(cls, specs) -> "FaultPlan":
        """Build a plan from CLI ``--chaos`` specs.  Grammar (repeatable)::

            preempt-finetune:K        preempt-squeeze:K
            crash-ckpt:mid_write[:STEP]   crash-ckpt:pre_latest[:STEP]
            io:SITE:N                 nan-decode:STEP[:SLOT]
            deny-pages:N              flash-raise
            expire-admit:K
            kill-pool:IDX:STEP        trip-pool:IDX
            shed-storm:K
        """
        plan = cls()
        for spec in specs:
            name, _, rest = spec.partition(":")
            args = rest.split(":") if rest else []
            try:
                if name == "preempt-finetune":
                    plan.preempt_finetune_step = int(args[0])
                elif name == "preempt-squeeze":
                    plan.preempt_squeeze_iter = int(args[0])
                elif name == "crash-ckpt":
                    if args[0] not in ("mid_write", "pre_latest"):
                        raise ValueError(args[0])
                    plan.crash_ckpt = args[0]
                    if len(args) > 1:
                        plan.crash_ckpt_step = int(args[1])
                elif name == "io":
                    plan.io_errors[args[0]] = int(args[1])
                elif name == "nan-decode":
                    plan.nan_decode_step = int(args[0])
                    if len(args) > 1:
                        plan.nan_decode_slot = int(args[1])
                elif name == "deny-pages":
                    plan.deny_page_admissions = int(args[0])
                elif name == "expire-admit":
                    plan.expire_admit_chunk = int(args[0])
                elif name == "flash-raise":
                    plan.flash_raises = True
                elif name == "kill-pool":
                    plan.kill_pool = (int(args[0]), int(args[1]))
                elif name == "trip-pool":
                    plan.trip_pool = int(args[0])
                elif name == "shed-storm":
                    plan.shed_storm = int(args[0])
                else:
                    raise ValueError(name)
            except (IndexError, ValueError):
                raise ValueError(
                    f"bad --chaos spec {spec!r}; see FaultPlan.parse for "
                    "the grammar") from None
        return plan


_ACTIVE: FaultPlan | None = None


def active() -> FaultPlan | None:
    return _ACTIVE


@contextlib.contextmanager
def fault_scope(plan: FaultPlan):
    """Activate ``plan`` for the dynamic extent of the block (including
    work running on other threads, e.g. the async checkpoint writer)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


# ---- site checks (each a no-op without an active plan) ----


def step_tick(site: str, index: int) -> None:
    """Preemption check at the top of a loop iteration."""
    p = _ACTIVE
    if p is None:
        return
    target = (p.preempt_finetune_step if site == "finetune"
              else p.preempt_squeeze_iter if site == "squeeze" else None)
    if target is not None and index == target:
        raise Preemption(f"injected preemption at {site} step {index}")


def crash_point(site: str, step: int | None = None) -> None:
    """Hard-kill check at a named point in a critical section (one-shot)."""
    p = _ACTIVE
    if p is None or p._crashed or p.crash_ckpt != site.split(":", 1)[-1]:
        return
    if p.crash_ckpt_step is not None and step != p.crash_ckpt_step:
        return
    p._crashed = True
    raise CrashPoint(f"injected crash at {site!r} (step {step})")


def io_check(site: str) -> None:
    """Transient-I/O check; consumes one scheduled failure per call."""
    p = _ACTIVE
    if p is None:
        return
    n = p.io_errors.get(site, 0)
    if n > 0:
        p.io_errors[site] = n - 1
        raise InjectedIOError(
            f"injected transient I/O error at {site!r} ({n - 1} more queued)")


def corrupt_decode_logits(logits, step: int):
    """Host float32 numpy copy of ``logits`` (a tensor) with the planned slot's
    row set to NaN when this is the chosen decode step, else ``None`` (no
    copy, no transfer).  One-shot: the fault is consumed when it fires, so
    only ONE pool in a replicated fleet is poisoned (the retry replica sees
    healthy logits)."""
    p = _ACTIVE
    if p is None or p.nan_decode_step is None or step != p.nan_decode_step:
        return None
    p.nan_decode_step = None        # consumed
    import numpy as np
    out = np.array(logits.detach().float().cpu().numpy(), np.float32)
    out[p.nan_decode_slot] = np.nan
    return out


def admit_chunk_expired(chunks_done: int) -> bool:
    """True when the plan expires the in-flight chunked admission after
    ``chunks_done`` prefill chunks (checked between chunks; one-shot)."""
    p = _ACTIVE
    if p is None or p.expire_admit_chunk is None:
        return False
    if chunks_done >= p.expire_admit_chunk:
        p.expire_admit_chunk = None     # consumed
        return True
    return False


def page_admission_denied() -> bool:
    """True while the plan still owes simulated pool-exhaustion denials."""
    p = _ACTIVE
    if p is None or p.deny_page_admissions <= 0:
        return False
    p.deny_page_admissions -= 1
    return True


def check_flash() -> None:
    """Raise as a failed flash decode-attention launch would."""
    p = _ACTIVE
    if p is not None and p.flash_raises:
        raise InjectedKernelError(
            "injected flash decode-attention kernel failure")


def pool_kill_due(step: int) -> int | None:
    """Replica index to "crash" at router step ``step`` (one-shot), else
    ``None``.  Checked at the top of ``PoolRouter.step``."""
    p = _ACTIVE
    if p is None or p.kill_pool is None or step != p.kill_pool[1]:
        return None
    idx = p.kill_pool[0]
    p.kill_pool = None              # consumed
    return idx


def pool_trip_due() -> int | None:
    """Replica index whose breaker the plan forces open (one-shot)."""
    p = _ACTIVE
    if p is None or p.trip_pool is None:
        return None
    idx, p.trip_pool = p.trip_pool, None
    return idx


def shed_request() -> bool:
    """True while the plan still owes forced front-door sheds."""
    p = _ACTIVE
    if p is None or p.shed_storm <= 0:
        return False
    p.shed_storm -= 1
    return True
