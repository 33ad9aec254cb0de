"""Device time of a call on the card, as ``chip_smoke.py`` and the profile
tools under ``tools/`` measure it."""

from __future__ import annotations

import time

import torch


def device_ms(fn, flush: torch.Tensor, reps: int = 10) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls, the L2 flushed before
    each by zeroing ``flush`` (a buffer on the card larger than its L2).  A
    GPU spin of three times ``fn``'s host time (at ~2 GHz) is queued between
    the flush and the start event, so the host enqueues ``fn``'s launches
    while the card spins and CUDA events time the card's work alone, not the
    wrapper's host time."""
    fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    fn()
    cycles = int(2e9 * max(5e-5, 3 * (time.perf_counter() - h0)))
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(cycles)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / reps
