"""Fault-tolerant checkpointing: atomic writes, keep-k, async save — the
port of ``repro.checkpoint.manager``.

Layout: ``<dir>/step_<n>/arrays.npz`` + ``meta.json``; the ``latest`` symlink
is flipped only after a fully-written checkpoint (atomic rename), so a crash
mid-save can never corrupt the restore point.  The layout and the array keys
are the reference's, so either package restores what the other wrote.

A tree is nested dicts of tensors (keys sorted), and the port's
``TrainState`` / ``OptState`` named tuples; a key joins the path with ``/``,
a named tuple's field written ``.<field>`` as JAX's path keys render it
(``.params/embed/cores/c0``, ``.opt_state/.step``).  bfloat16 is written as
float32 (npz has no bfloat16; the widening is exact) and restored in the
template's dtype.  A ``None`` leaf (a frozen leaf's optimizer state) writes
nothing and comes back ``None``; a Python int or float leaf (``OptState.step``)
comes back as one.

Durability contract (exercised by ``tests/test_torch_resilience.py`` with
``resilience.faults`` crash points):

* a kill at ANY point inside ``_write`` leaves either the previous intact
  checkpoint reachable through ``latest`` (crash before the symlink flip) or
  the new one (crash after) — never a torn one;
* transient ``OSError``s are retried with exponential backoff
  (``io_retries`` / ``io_backoff``) before surfacing;
* an async save that failed re-raises its error on the next ``save()`` or
  ``wait()`` instead of losing it silently, and in-flight writers are joined
  at interpreter exit (``atexit``) so a clean shutdown never truncates a
  checkpoint.

Trees on a mesh (DTensor leaves, ``parallel.sharding``) are saved from the
whole tensors — every rank gathers, rank 0 writes — so the files are the
same as one device's, and ``restore`` puts them back on the template's
placements, or on other ones (``shardings=``): a checkpoint saved under one
layout restores onto another.  The directory must be one that every rank
sees (a shared filesystem on more than one host); ``latest_step`` and
``restore`` are called on every rank and read only what rank 0 has
finished writing.

``save`` snapshots the tree into host memory before it returns, as a COPY:
the optimizers write the parameters in place, and on the CPU a tensor's
``.numpy()`` shares its storage, so a writer thread holding a view would
write whatever values the next step left there.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import threading
import time
import weakref

import numpy as np
import torch

from repro_torch.resilience import faults


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree):
    """The (key, child) pairs of a container node (a dict or a named tuple)
    in JAX's leaf order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    return None


def _rebuild(node, kids: list):
    """A container like ``node`` holding ``kids`` (in ``_items`` order)."""
    if isinstance(node, dict):
        return dict(zip(sorted(node), kids))
    return type(node)(*kids)


def _walk(tree, prefix=""):
    """(key, leaf) for every leaf, ``None`` leaves included."""
    items = _items(tree)
    if items is None:
        yield prefix, tree
        return
    for k, v in items:
        yield from _walk(v, f"{prefix}/{k}" if prefix else k)


def _is_dtensor(leaf) -> bool:
    from repro_torch.parallel.spmd import is_dtensor
    return is_dtensor(leaf)


def _in_group() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of a process group,
    or a process with none."""
    import torch.distributed as dist
    return not _in_group() or dist.get_rank() == 0


def _host_copy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if _is_dtensor(t):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:        # npz has no bf16; exact widening
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _flatten(tree) -> dict[str, np.ndarray]:
    """{key: host copy} of every non-``None`` leaf."""
    return {k: _host_copy(v) for k, v in _walk(tree) if v is not None}


def _unflatten_into(template, arrays: dict[str, np.ndarray], device=None):
    """``template``'s structure with each leaf read from ``arrays``: shapes
    from the arrays (squeezed bonds differ from a config's), dtypes from the
    template, tensors on ``device`` (each template leaf's own when None).
    A key the template has and the arrays lack, or the reverse, raises."""
    want = {k for k, v in _walk(template) if v is not None}
    missing, extra = sorted(want - set(arrays)), sorted(set(arrays) - want)
    if missing or extra:
        raise KeyError(f"checkpoint arrays differ from the template: missing {missing}, "
                       f"extra {extra}")

    def build(node, prefix):
        items = _items(node)
        if items is None:
            if node is None:
                return None
            a = arrays[prefix]
            if _is_dtensor(node):                 # back onto the template's placements
                from repro_torch.parallel.sharding import place
                whole = torch.from_numpy(np.ascontiguousarray(a)).to(
                    device=node.to_local().device if device is None else device,
                    dtype=node.dtype)
                return place(whole, node.device_mesh, node.placements)
            if isinstance(node, torch.Tensor):
                return torch.from_numpy(np.ascontiguousarray(a)).to(
                    device=node.device if device is None else device, dtype=node.dtype)
            return type(node)(a)              # a Python scalar (OptState.step)
        return _rebuild(node, [build(v, f"{prefix}/{k}" if prefix else k) for k, v in items])

    return build(template, "")


@torch.no_grad()
def copy_into(live, saved):
    """Write ``saved`` (a tree of ``live``'s structure) into ``live``'s
    tensors in place and return ``live``'s structure holding them; a
    non-tensor leaf (``OptState.step``) is taken from ``saved``.  The train
    state's parameters ARE the model's, so a resume must write into them:
    rebinding a name would leave the model on the old values.  Any shape
    or dtype difference raises before anything is written."""
    pairs = list(zip(_walk(live), _walk(saved), strict=True))
    for (k, a), (k2, b) in pairs:
        if k != k2 or (a is None) != (b is None):
            raise KeyError(f"trees differ at {k!r} / {k2!r}")
        if isinstance(a, torch.Tensor) and (a.shape != b.shape or a.dtype != b.dtype):
            raise ValueError(f"{k}: live {tuple(a.shape)} {a.dtype}, saved "
                             f"{tuple(b.shape)} {b.dtype}")
    for (_, a), (_, b) in pairs:
        if isinstance(a, torch.Tensor):
            a.copy_(b)

    def rebuild(a, b):
        items = _items(a)
        if items is None:
            return a if isinstance(a, torch.Tensor) else b
        return _rebuild(a, [rebuild(x, y) for (_, x), (_, y) in zip(items, _items(b))])

    return rebuild(live, saved)


# managers with potentially in-flight async writers, joined at interpreter
# exit so a clean process shutdown never abandons a half-written checkpoint
_LIVE_MANAGERS: "weakref.WeakSet[CheckpointManager]" = weakref.WeakSet()


@atexit.register
def _drain_managers() -> None:  # pragma: no cover - exercised at exit
    for mgr in list(_LIVE_MANAGERS):
        try:
            mgr.wait()
        except BaseException:
            pass  # exiting anyway; the atomic layout bounds the damage


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 io_retries: int = 3, io_backoff: float = 0.05):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self.io_retries = io_retries
        self.io_backoff = io_backoff
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._io(os.makedirs, directory, exist_ok=True)
        _LIVE_MANAGERS.add(self)

    # ---- save ----

    def save(self, step: int, tree, extra_meta: dict | None = None,
             block: bool = False):
        """Snapshot ``tree`` to host memory (a copy, synchronously), then
        write it: on a background thread unless ``block`` or the manager is
        synchronous.  Returns once the snapshot is taken."""
        arrays = _flatten(tree)
        meta = {"step": int(step), **(extra_meta or {})}
        self.wait()  # never two writers (same step dir -> corruption race);
        # also surfaces the PREVIOUS async save's failure before this one
        # silently papers over it
        if not _writes():
            return
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, arrays, meta),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, arrays, meta)

    def _write_guarded(self, step: int, arrays, meta):
        try:
            self._write(step, arrays, meta)
        except BaseException as e:  # held for the next save()/wait() to raise
            self._error = e

    def _io(self, fn, *args, **kwargs):
        """Run one filesystem operation, retrying transient ``OSError``s
        with exponential backoff (I/O faults injected at site ``"ckpt"``)."""
        delay = self.io_backoff
        for attempt in range(self.io_retries + 1):
            try:
                faults.io_check("ckpt")
                return fn(*args, **kwargs)
            except OSError:
                if attempt == self.io_retries:
                    raise
                time.sleep(delay)
                delay *= 2

    def _write(self, step: int, arrays, meta):
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        self._io(os.makedirs, tmp)
        faults.crash_point("ckpt:mid_write", step)
        self._io(np.savez, os.path.join(tmp, "arrays.npz"), **arrays)

        def _dump_meta():
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)

        self._io(_dump_meta)
        if os.path.exists(final):
            shutil.rmtree(final)
        self._io(os.rename, tmp, final)  # atomic publish
        faults.crash_point("ckpt:pre_latest", step)
        latest = os.path.join(self.dir, "latest")
        tmp_link = latest + ".tmp"
        if os.path.lexists(tmp_link):
            os.remove(tmp_link)
        self._io(os.symlink, f"step_{step}", tmp_link)
        self._io(os.replace, tmp_link, latest)
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def wait(self):
        """Join the in-flight async writer (if any) and re-raise the error
        it hit, if it hit one — a failed save must never stay invisible."""
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # ---- restore ----

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        """The restore point (see ``_latest_step``).  Under a process group
        every rank calls it: rank 0 finishes its own write first, then sends
        the step it finds, so every rank resumes from the same one."""
        self.wait()
        if not _in_group():
            return self._latest_step()
        import torch.distributed as dist
        box = [self._latest_step() if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _latest_step(self) -> int | None:
        """The restore point: the step the ``latest`` symlink names, when it
        points at an intact checkpoint — crash-consistency comes from the
        symlink being flipped only AFTER a full write, so a step dir that
        exists but was never linked (crash between publish and flip) is not
        preferred over the last known-good one.  Falls back to the newest
        complete step dir when the symlink is missing/dangling."""
        link = os.path.join(self.dir, "latest")
        try:
            target = os.readlink(link)
            step = int(target.rsplit("_", 1)[1])
            if os.path.exists(os.path.join(self.dir, target, "arrays.npz")):
                return step
        except (OSError, ValueError, IndexError):
            pass
        steps = [s for s in self.all_steps()
                 if os.path.exists(os.path.join(self.dir, f"step_{s}",
                                                "arrays.npz"))]
        return steps[-1] if steps else None

    def restore(self, step: int | None, template, device=None, shardings=None,
                mesh=None):
        """``(tree, meta)`` of checkpoint ``step`` (the latest when None) in
        ``template``'s structure: new tensors, shapes from the arrays,
        dtypes from the template, on ``device`` (each template leaf's own
        when None).  A DTensor template leaf comes back on its placements;
        ``shardings`` (a placement tree, ``parallel.sharding.tree_shardings``)
        with ``mesh`` places the restored tree on that mesh instead — the
        elastic re-layout.  Under a process group every rank calls it, and
        rank 0's write of the step is done before any rank reads it (the
        directory is one that every rank sees: rank 0 alone writes)."""
        if step is None:
            step = self.latest_step()
        elif _in_group():
            import torch.distributed as dist
            self.wait()
            dist.barrier()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}", "arrays.npz")
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        tree = _unflatten_into(template, arrays, device)
        if shardings is not None:
            if mesh is None:
                raise ValueError("restore(shardings=...) needs the mesh they are on")
            from repro_torch.parallel.sharding import place_tree
            tree = place_tree(tree, shardings, mesh)
        meta_path = os.path.join(self.dir, f"step_{step}", "meta.json")
        with open(meta_path) as f:
            meta = json.load(f)
        return tree, meta
