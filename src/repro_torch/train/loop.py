"""Fault-tolerant training loop: checkpoint/resume, deterministic data,
metrics logging — the port of ``repro.train.loop``."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.checkpoint.manager import CheckpointManager, copy_into
from repro_torch.resilience import faults
from repro_torch.train.steps import TrainState


@dataclasses.dataclass
class LoopConfig:
    steps: int
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    log_every: int = 10
    keep: int = 3


def run_training(train_step: Callable, state: TrainState, batch_fn: Callable,
                 loop: LoopConfig, to_device: Callable = lambda b: b,
                 log_fn: Callable = print):
    """Runs ``loop.steps`` steps, resuming from the latest checkpoint in
    ``loop.ckpt_dir`` if one exists; ``batch_fn(step)`` must be
    deterministic (restart-safe).  The state's parameters are the model's
    own tensors, updated in place, so a resume writes the checkpoint into
    them (and into the optimizer state's tensors) rather than rebinding.
    With ``ckpt_dir``: an async save every ``ckpt_every`` steps, a blocking
    one at the end (in place of the last step's async one, which the
    reference writes too), and on ``faults.Preemption`` (the SIGTERM drain) a
    blocking save of the completed steps before re-raising.  Metrics are
    read back (a host sync) only on logged steps: the first and every
    ``log_every``-th.  Returns ``(state, history)``."""
    mgr = None
    start = 0
    if loop.ckpt_dir:
        mgr = CheckpointManager(loop.ckpt_dir, keep=loop.keep)
        latest = mgr.latest_step()
        if latest is not None:
            saved, meta = mgr.restore(latest, state)
            state = copy_into(state, saved)
            start = meta["step"]
            log_fn(f"[loop] resumed from step {start}")

    history = []
    t0 = time.time()
    for step in range(start, loop.steps):
        try:
            faults.step_tick("finetune", step)  # chaos: preemption-at-step-k
        except faults.Preemption:
            if mgr:
                # SIGTERM drain: persist the completed-steps state so resume
                # restarts HERE, not at the last periodic checkpoint
                mgr.save(step, state, block=True)
                log_fn(f"[loop] preempted at step {step}; state saved")
            raise
        state, metrics = train_step(state, to_device(batch_fn(step)))
        if (step + 1) % loop.log_every == 0 or step == start:
            m = {k: float(v) for k, v in metrics.items()}
            dt = (time.time() - t0) / max(step + 1 - start, 1)
            log_fn(f"[loop] step={step + 1} loss={m.get('loss', 0):.4f} "
                   f"({dt * 1e3:.0f} ms/step)")
            history.append({"step": step + 1, **m})
        if mgr and (step + 1) % loop.ckpt_every == 0 and step + 1 < loop.steps:
            mgr.save(step + 1, state)     # the last step's is the blocking save below
    if mgr:
        mgr.save(loop.steps, state, block=True)
    return state, history
