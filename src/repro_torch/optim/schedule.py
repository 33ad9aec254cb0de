"""Learning-rate schedules (pure functions of the step counter) — the port
of ``repro.optim.schedule``.  Computed in float32, as the reference's jnp
schedules are, and returned as Python floats."""

from __future__ import annotations

import numpy as np


def constant(lr: float):
    return lambda step: float(np.float32(lr))


def cosine_warmup(peak: float, warmup: int, total: int, floor: float = 0.0):
    def fn(step):
        step = np.float32(step)
        if step < warmup:
            return float(peak * step / np.float32(max(warmup, 1)))
        frac = np.clip((step - warmup) / np.float32(max(total - warmup, 1)), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + np.cos(np.float32(np.pi) * frac))
        return float(np.float32(cos))
    return fn
