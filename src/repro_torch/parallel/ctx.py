"""The mesh context — the port of ``repro.parallel.ctx``.

``with current_mesh(mesh):`` (or ``maybe_mesh``, a no-op for ``None``)
installs the mesh a step runs under, and ``sequence_parallel()`` marks the
sequence-parallel layout; ``get_mesh`` / ``is_sp`` read them.  The
reference's activation pins (``shard_activation``, ``gather_seq``,
``shard_batch_dim``, ``shard_dims``: ``with_sharding_constraint`` at the
model's layout points) have no counterpart: the port's mesh path keeps
activations as plain tensors on every rank (``parallel.spmd``), so there is
no activation layout to pin.
"""

from __future__ import annotations

import contextlib

_MESH = None
_SP = False  # sequence-parallel activation layout


@contextlib.contextmanager
def current_mesh(mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


@contextlib.contextmanager
def sequence_parallel(enabled: bool = True):
    global _SP
    prev = _SP
    _SP = enabled
    try:
        yield
    finally:
        _SP = prev


@contextlib.contextmanager
def maybe_mesh(mesh):
    """``current_mesh(mesh)`` when a mesh is given, no-op otherwise, so
    serving code wraps its steps unconditionally."""
    if mesh is None:
        yield None
    else:
        with current_mesh(mesh) as m:
            yield m


def get_mesh():
    return _MESH


def is_sp() -> bool:
    return _SP
