"""Training loop with deterministic data and metrics logging — the port of
``repro.train.loop``.

Checkpoint/resume (``ckpt_dir``) comes with persistence (ROADMAP.md, Queue
1 item 3), and the chaos harness's preemption hook with the serving front
end's resilience modules (Queue 1 item 4).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.train.steps import TrainState


@dataclasses.dataclass
class LoopConfig:
    steps: int
    ckpt_dir: str | None = None
    log_every: int = 10


def run_training(train_step: Callable, state: TrainState, batch_fn: Callable,
                 loop: LoopConfig, to_device: Callable = lambda b: b,
                 log_fn: Callable = print):
    """Runs ``loop.steps`` steps; ``batch_fn(step)`` must be deterministic.
    Metrics are read back (a host sync) only on logged steps: the first and
    every ``log_every``-th.  Returns ``(state, history)``."""
    if loop.ckpt_dir:
        raise NotImplementedError("checkpoint/resume (ckpt_dir) comes with ROADMAP.md, "
                                  "Queue 1 item 3 (persistence)")
    history = []
    t0 = time.time()
    for step in range(loop.steps):
        state, metrics = train_step(state, to_device(batch_fn(step)))
        if (step + 1) % loop.log_every == 0 or step == 0:
            m = {k: float(v) for k, v in metrics.items()}
            dt = (time.time() - t0) / (step + 1)
            log_fn(f"[loop] step={step + 1} loss={m.get('loss', 0):.4f} "
                   f"({dt * 1e3:.0f} ms/step)")
            history.append({"step": step + 1, **m})
    return state, history
