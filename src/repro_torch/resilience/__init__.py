"""Fault-tolerant lifecycle: session save/restore, squeeze journaling, and
deterministic fault injection — the port of ``repro.resilience``.

Three pieces:

* ``resilience.faults`` — a deterministic chaos harness: ``FaultPlan``
  names where/when faults fire (preemption at step k, a crash before the
  ``latest`` symlink flip, transient I/O errors); activated via
  ``fault_scope``.
* ``resilience.state`` — the atomic manifest behind ``Session.save`` /
  ``Session.restore`` (weights + stage records + squeeze history + mask,
  crash-consistent end to end).
* ``resilience.journal`` — per-iteration journaling for Algorithm 2 so a
  preempted squeeze resumes at the last completed iteration
  (``Session.squeeze(ckpt_dir=...)``).

``faults`` is imported eagerly (stdlib-only, and the instrumented sites in
``checkpoint``/``train``/``core`` need it cheap); the heavier state/journal
modules resolve lazily to keep import edges acyclic.
"""

from __future__ import annotations

import importlib

from repro_torch.resilience.faults import (CrashPoint, FaultPlan,  # noqa: F401
                                           InjectedIOError, InjectedKernelError,
                                           Preemption, fault_scope)

__all__ = [
    "FaultPlan", "fault_scope", "Preemption", "CrashPoint",
    "InjectedIOError", "InjectedKernelError",
    "SqueezeJournal", "save_session", "restore_session",
    "faults", "journal", "state",
]

_LAZY = {
    "SqueezeJournal": ("repro_torch.resilience.journal", "SqueezeJournal"),
    "save_session": ("repro_torch.resilience.state", "save_session"),
    "restore_session": ("repro_torch.resilience.state", "restore_session"),
    "journal": ("repro_torch.resilience.journal", None),
    "state": ("repro_torch.resilience.state", None),
}


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(
            f"module 'repro_torch.resilience' has no attribute {name!r}")
    module = importlib.import_module(target[0])
    value = module if target[1] is None else getattr(module, target[1])
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
