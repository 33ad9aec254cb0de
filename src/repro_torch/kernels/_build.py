"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ``ctypes``.

Each ``repro_torch/csrc/<name>.cu`` is compiled on its own into
``build/kernels/<name>-<hash>.so`` at the repository root (``.gitignore``
lists ``build/``), for ``sm_90a``, at first use.  The hash covers the
source and the flags, so an edited source is rebuilt and an unchanged one
is reused.  The C entry points take raw device pointers and the CUDA
stream, launch on the current device, and return ``cudaGetLastError()``;
the Python wrappers call them through ``launch``, which makes the tensors'
device current and raises ``KernelLaunchError`` when that is not 0.
``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills) is kept
beside each library as ``<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class KernelLaunchError(RuntimeError):
    """A kernel's entry point returned a CUDA error.  The serving router
    (``pipeline.router.PoolRouter``) counts it as its replica's crash; a
    sticky fault that poisons the CUDA context cannot be recovered in the
    process, and the next CUDA call raises again."""


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "port's CUDA kernels are built on the machine that "
                           "runs them")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every named source (default: all) that has no current
    library, one ``nvcc`` process per source, all started together.
    Returns ``{name: library path}``; raises with the compiler's output
    when a build fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _target(n) for n in names}
    procs = {}
    for name, so in todo.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        log = open(so.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, so, log)
    failed = []
    for name, (proc, tmp, so, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, so)
        else:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          f"{so.with_suffix('.log').read_text()}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return todo


def build_log(name: str) -> str:
    """The compiler's report for the current build of ``name``."""
    return _target(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build([name])[name]))
        return lib


def refuse_dtensor(where: str, *tensors) -> None:
    """Raise ``TypeError`` if any of ``tensors`` is a DTensor: a kernel reads
    raw pointers (``launch``), and a DTensor's would be its local block's
    with the global shape's meaning — silently wrong.  Mesh code hands the
    wrappers local shards (``parallel.spmd``)."""
    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{where}: got a DTensor; kernels take local shards "
                        "(DTensor.to_local())")


def launch(name: str, x: torch.Tensor, call) -> None:
    """``call(stream)`` with tensor ``x``'s device current and its current
    stream (the C entry points launch on the current device); raises when it
    returns a CUDA error."""
    idx = x.device.index
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if idx is None or idx == torch.cuda.current_device():
        rc = call(stream)
    else:
        with torch.cuda.device(idx):
            rc = call(stream)
    if rc != 0:
        raise KernelLaunchError(f"{name} launch failed: CUDA error {rc}")
