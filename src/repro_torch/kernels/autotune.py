"""Measured autotuning of the MPO-linear execution — the port of
``repro.kernels.autotune``.

The engine's analytic plan (FLOPs, then the kernels' gate
``kernel_eligible``) says where the fused kernel *can* run, not whether it
is the fastest there.  On the card this module measures it instead: per
``(core shapes, token count, phase, dtype)`` key it times a small candidate
grid on synthetic operands of the key's shapes and dtype, drawn from a
seeded ``torch.Generator`` on the key's device, and records which candidate
wins and at which row tile:

* ``factorized`` — the chain contraction (``mpo.apply_mpo``);
* ``reconstruct`` — W rebuilt, then a dense product (``mpo.matmul_reconstruct``);
* ``kernel@<bm>`` — on CUDA only, where ``kernel_eligible`` admits the
  shapes: the fused forward ``forward_kernel`` names at each row tile it is
  built for (``MMA_BM`` on ``csrc/mpo_linear_mma.cu``, ``NARROW_BM`` on
  ``csrc/mpo_linear.cu``, each with the rest of its plan reckoned for the
  tile) that fits, deduplicated by the tile's effective height (at 16 rows
  or fewer every tile is 16 rows: one candidate).

``train`` times forward plus backward (``torch.autograd.grad`` of
``sum(|y|)`` with respect to the cores and x; the kernel through
``MPOLinearFn``: its dL/dx and the cores backward), ``prefill`` the forward
alone.  Each candidate runs once to warm up, then the best of three on the
wall clock from its enqueue to ``torch.cuda.synchronize()``: the time the
path pays, the host's dispatch included.  An expert stack is tuned as one
matrix of the stack's shape at its rows an expert, as the engine plans it.
A kernel candidate that fails to build or launch raises: it is never
quietly dropped from the race.

Verdicts persist in a JSON cache, so a later process (the next serving
session, a fleet that imported them) pays no tuning:

* location: ``~/.cache/repro_torch/autotune.json``, or the
  ``REPRO_TORCH_AUTOTUNE_CACHE`` variable's path;
* an unreadable, stale or other-version file is ignored (re-tuned and
  rewritten), never crashed on; writing is atomic and best-effort, and the
  file is re-read before each write, so writers sharing it merge;
* a key names its substrate (the card's name and compute capability, or
  ``cpu``; torch's and CUDA's versions), so a verdict measured on another
  card or build never answers a lookup.

The names differ from the reference's (``REPRO_AUTOTUNE_*``,
``~/.cache/repro``, its ``CACHE_VERSION``) so that a process running both
packages keeps their settings and files apart; each package's importer
takes nothing from the other's file.

Measuring happens where it means something: by default exactly when the
plan's device is a CUDA device present in this process, the counterpart of
the reference's compiled TPU kernels; elsewhere planning stays analytic.
``REPRO_TORCH_AUTOTUNE_MEASURE`` forces it on (``1``: tests, a CPU
bring-up) or off (``0``)::

    from repro_torch.kernels import autotune
    autotune.get_tuner().stats()   # {"path": ..., "keys_resolved": 3, "timing_runs": 0}
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Sequence

import torch

from repro_torch.core import mpo
from repro_torch.kernels.mpo_linear import (MMA_BM, NARROW_BM, MPOLinearFn, forward_kernel,
                                            forward_plan, kernel_eligible)

ENV_CACHE = "REPRO_TORCH_AUTOTUNE_CACHE"
ENV_MEASURE = "REPRO_TORCH_AUTOTUNE_MEASURE"

CACHE_VERSION = 1
TILES = {"mma": MMA_BM, "cuda_core": NARROW_BM}   # the row tiles of each forward route
TILE_ALIGN = 16          # rows of one tensor-core fragment: tiles dedupe at this height
BENCH_WARMUP = 1         # build + cache warm, excluded from timing
BENCH_REPS = 3           # best-of

_TUNABLE_MODES = ("factorized", "reconstruct", "kernel")
_BLOCK_MS = (0,) + tuple(sorted(set(MMA_BM) | set(NARROW_BM)))   # 0: the kernel's own plan


def cache_path() -> str:
    env = os.environ.get(ENV_CACHE)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json")


def should_measure(device_type: str) -> bool:
    """Measure (vs the analytic plan)?  Default: for a CUDA device when this
    process has one; ``REPRO_TORCH_AUTOTUNE_MEASURE=1/0`` forces either
    way."""
    env = os.environ.get(ENV_MEASURE)
    if env == "0":
        return False
    if env == "1":
        return True
    return device_type == "cuda" and torch.cuda.is_available()


def substrate(device_type: str) -> str:
    """What a measurement was taken on: the card's name and compute
    capability (the current CUDA device), or the device type, with torch's
    and CUDA's versions."""
    if device_type == "cuda":
        idx = torch.cuda.current_device()
        major, minor = torch.cuda.get_device_capability(idx)
        dev = f"{torch.cuda.get_device_name(idx)}|cc={major}.{minor}"
    else:
        dev = device_type
    return f"device={dev}|torch={torch.__version__}|cuda={torch.version.cuda}"


def make_key(shapes: Sequence[tuple], tokens: int, phase: str, dtype: str,
             device: str = "cpu") -> str:
    """Cache key: the measurement's substrate (``substrate``), then the
    shapes, tokens, phase and dtype, as the reference's."""
    s = ";".join("x".join(str(d) for d in sh) for sh in shapes)
    return (f"{substrate(torch.device(device).type)}"
            f"|shapes={s}|tokens={int(tokens)}|phase={phase}|dtype={dtype}")


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """One tuning verdict: the winning execution mode and kernel tile."""

    mode: str                 # factorized | reconstruct | kernel
    block_m: int              # the kernel's measured row tile; 0 otherwise
    source: str               # "measured" | "disk"
    timings: tuple = ()       # ((candidate label, seconds), ...) sorted


def _block_m_candidates(shapes: Sequence[tuple], tokens: int, phase: str, dtype: str,
                        device_type: str) -> list[int]:
    """The row tiles worth racing: none off CUDA or where the kernels' gate
    refuses the shapes; else each tile of the route ``forward_kernel``
    names whose plan fits at ``tokens`` rows, deduplicated by effective tile
    (a 16-row call makes every tile 16 rows: time it once)."""
    if device_type != "cuda" or not kernel_eligible(shapes, dtype=dtype,
                                                    train=phase == "train"):
        return []
    cap = TILE_ALIGN * -(-max(int(tokens), 1) // TILE_ALIGN)
    out, seen = [], set()
    for bm in TILES[forward_kernel(shapes, dtype)]:
        eff = min(bm, cap)
        if eff not in seen and forward_plan(shapes, tokens, dtype, bm) is not None:
            seen.add(eff)
            out.append(bm)
    return out


def _candidates(shapes, tokens, phase, dtype, device):
    """[(label, zero-arg fn)] — the engine's implementations over synthetic
    operands of the tuned shapes on ``device``; ``train`` runs forward and
    backward, the others the forward under ``no_grad``."""
    dev = torch.device(device)
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    cores = [torch.randn(s, generator=gen, device=dev).to(tdt) for s in shapes]
    i_dim = math.prod(s[1] for s in shapes)
    x = torch.randn(int(tokens), i_dim, generator=gen, device=dev).to(tdt)
    fwd = {"factorized": lambda cs, xs: mpo.apply_mpo(cs, xs),
           "reconstruct": lambda cs, xs: mpo.matmul_reconstruct(xs, cs)}
    for bm in _block_m_candidates(shapes, tokens, phase, dtype, dev.type):
        fwd[f"kernel@{bm}"] = lambda cs, xs, bm=bm: MPOLinearFn.apply(xs, bm, *cs)
    if phase == "train":
        cores = [c.requires_grad_() for c in cores]
        x.requires_grad_()

        def run(fn):
            with torch.enable_grad():        # planning may happen under no_grad
                return torch.autograd.grad(fn(cores, x).abs().sum(), (*cores, x))
    else:
        def run(fn):
            with torch.no_grad():
                return fn(cores, x)
    return [(label, lambda fn=fn: run(fn)) for label, fn in fwd.items()]


def _parse_label(label: str) -> tuple[str, int]:
    if label.startswith("kernel@"):
        return "kernel", int(label.split("@", 1)[1])
    return label, 0


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _read_cache(path: str) -> dict:
    """Entries from disk; anything unreadable or stale is dropped (the
    caller re-tunes and rewrites)."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(raw, dict) or raw.get("version") != CACHE_VERSION:
        return {}
    entries = raw.get("entries")
    if not isinstance(entries, dict):
        return {}
    out = {}
    for key, ent in entries.items():
        if (isinstance(ent, dict) and ent.get("mode") in _TUNABLE_MODES
                and type(ent.get("block_m")) is int and ent["block_m"] in _BLOCK_MS
                and (ent["mode"] == "kernel" or ent["block_m"] == 0)):
            out[key] = ent
    return out


def _write_cache(path: str, entries: dict) -> None:
    """Atomic best-effort persist: an unwritable cache directory never
    fails planning."""
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"version": CACHE_VERSION, "entries": entries}, f, indent=2,
                      sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    except OSError:
        pass


class Autotuner:
    """Memory -> disk -> measure lookup chain for tuning verdicts.

    ``timing_runs`` counts timed candidates: it stays 0 when a warm disk
    cache answers every lookup.
    """

    def __init__(self, path: str | None = None):
        self._path = path
        self._mem: dict[str, TuneResult] = {}
        self._disk: dict | None = None
        self.timing_runs = 0

    @property
    def path(self) -> str:
        return self._path or cache_path()

    def _entries(self) -> dict:
        if self._disk is None:
            self._disk = _read_cache(self.path)
        return self._disk

    def get(self, shapes: Sequence[tuple], tokens: int, phase: str, dtype: str,
            device: str = "cpu", candidates_fn=None) -> TuneResult:
        """The verdict for one key.  ``candidates_fn`` defaults to the
        MPO-linear grid; another race passes its own ``(shapes, tokens,
        phase, dtype, device) -> [(label, thunk)]`` function and shares the
        cache."""
        shapes = tuple(tuple(int(d) for d in s) for s in shapes)
        key = make_key(shapes, tokens, phase, dtype, device)
        hit = self._mem.get(key)
        if hit is not None:
            return hit
        ent = self._entries().get(key)
        if ent is not None:
            result = TuneResult(mode=ent["mode"], block_m=ent["block_m"], source="disk",
                                timings=tuple(sorted((ent.get("timings") or {}).items(),
                                                     key=lambda kv: kv[1])))
            self._mem[key] = result
            return result
        result = self.measure(shapes, tokens, phase, dtype, device, candidates_fn)
        self._mem[key] = result
        # re-read before persisting: another process may have tuned other
        # keys since the first load, and writing the stale snapshot would
        # erase their verdicts
        entries = _read_cache(self.path)
        entries[key] = {"mode": result.mode, "block_m": result.block_m,
                        "timings": dict(result.timings)}
        self._disk = entries
        _write_cache(self.path, entries)
        return result

    def measure(self, shapes, tokens, phase, dtype, device="cpu",
                candidates_fn=None) -> TuneResult:
        """Race the candidates.  Planning may happen inside a checkpointed
        (remat) forward, whose saved-tensor hooks would drop what a ``train``
        candidate's backward needs and recompute the layer, re-entering
        planning: the race keeps its own tensors."""
        candidates_fn = candidates_fn or _candidates
        with torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t):
            timings = [(label, self._time(fn)) for label, fn in
                       candidates_fn(shapes, tokens, phase, dtype, device)]
        timings.sort(key=lambda kv: kv[1])
        mode, block_m = _parse_label(timings[0][0])
        return TuneResult(mode=mode, block_m=block_m, source="measured",
                          timings=tuple(timings))

    def stats(self) -> dict:
        """Where the cache lives, how many keys this process resolved, and
        how many timed candidates it paid for (0: fully warm);
        ``Session.report`` embeds it."""
        return {"path": self.path, "keys_resolved": len(self._mem),
                "timing_runs": self.timing_runs}

    def _time(self, fn) -> float:
        self.timing_runs += 1
        for _ in range(BENCH_WARMUP):
            fn()
            _sync()
        best = float("inf")
        for _ in range(BENCH_REPS):
            t0 = time.perf_counter()
            fn()
            _sync()
            best = min(best, time.perf_counter() - t0)
        return best


# ---- fleet warm start: shippable verdict artifacts ----


def export_cache(dest: str) -> dict:
    """Pack the verdict cache into an artifact at ``dest`` (the cache's own
    schema, so the artifact is itself a valid cache).  Returns
    ``{"exported": n, "path": dest}``."""
    entries = _read_cache(cache_path())
    if _tuner is not None:
        # a tuner pointed at its own path may hold more
        entries.update(_read_cache(_tuner.path))
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    tmp = f"{dest}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"version": CACHE_VERSION, "entries": entries}, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, dest)
    return {"exported": len(entries), "path": dest}


def import_cache(src: str, *, overwrite: bool = False) -> dict:
    """Merge an exported artifact into the local verdict cache.  Local
    verdicts win on a conflict unless ``overwrite`` (a verdict measured
    here is at least as fresh as a shipped one).  An invalid, stale or
    other-package artifact imports nothing and fails nothing; the cache
    file is written only when something was added.  Returns the counts."""
    incoming = _read_cache(src)
    path = _tuner.path if _tuner is not None else cache_path()
    local = _read_cache(path)
    added = 0
    for key, ent in incoming.items():
        if overwrite or key not in local:
            local[key] = ent
            added += 1
    if added:
        _write_cache(path, local)
        if _tuner is not None:
            _tuner._disk = None     # the next lookup re-reads the merged cache
    return {"imported": added, "skipped": len(incoming) - added, "total": len(local),
            "path": path}


_tuner: Autotuner | None = None


def get_tuner() -> Autotuner:
    """The process-wide tuner, which the engine's planning consults."""
    global _tuner
    if _tuner is None:
        _tuner = Autotuner()
    return _tuner


def reset_tuner(path: str | None = None) -> Autotuner:
    """A fresh tuner (dropping the in-memory verdicts, so the disk cache is
    read again).  The engine memoizes its plans on top of the tuner: clear
    them too (``core.engine.clear_plan_cache``)."""
    global _tuner
    _tuner = Autotuner(path)
    return _tuner
