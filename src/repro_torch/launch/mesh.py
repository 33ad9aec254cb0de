"""Process groups and meshes — the port of ``repro.launch.mesh``.

One process per device.  ``init_world`` sets up the default process group
explicitly (NCCL on the card, gloo on the CPU); ``spawn`` runs a function
on ``world`` ranks of their own (tests, tools); a world of one is set up
in-process (``ensure_world``), so ``python -m repro_torch.launch.train``
and ``chip_smoke.py`` need no ``torchrun``.  Meshes are
``torch.distributed.device_mesh.DeviceMesh`` objects over the world; rank
r runs on ``cuda:<local rank>``.  Importing this module touches no device
and no process group.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist


def init_world(backend: str | None, rank: int, world: int, init_method: str, *,
               device_type: str = "cuda", timeout_s: float | None = None):
    """Join the default process group as ``rank`` of ``world``:
    ``backend`` None takes NCCL for ``device_type="cuda"`` (which must be
    available: no move to the CPU), gloo for ``"cpu"``.  ``init_method`` is
    ``tcp://host:port`` or ``file://<path>`` (tests: no port to collide
    on).  On the card the rank's device is ``cuda:<LOCAL_RANK or rank>``.
    ``timeout_s`` bounds a collective's wait (a peer that died)."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_world: no CUDA device is available; pass "
                               "device_type='cpu' to run ranks on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            **kw)


def ensure_world(device_type: str = "cuda") -> bool:
    """Join the world ``torchrun`` describes (``RANK`` / ``WORLD_SIZE`` /
    ``MASTER_ADDR`` in the environment), or set up a world of one in this
    process.  Returns True when it set one up (the caller tears it down
    with ``dist.destroy_process_group``), False when a group existed."""
    if dist.is_initialized():
        return False
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init_world(None, int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://",
                   device_type=device_type)
        return True
    fd, path = tempfile.mkstemp(prefix="repro_torch_world_")
    os.close(fd)
    os.unlink(path)
    init_world(None, 0, 1, f"file://{path}", device_type=device_type)
    return True


def _spawned(rank, fn, world, init_method, device_type, args):
    torch.set_num_threads(1)
    init_world(None, rank, world, init_method, device_type=device_type)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, device_type: str = "cpu", init_method: str | None = None):
    """Run ``fn(rank, world, *args)`` on ``world`` new processes, each in a
    process group of its own (gloo on the CPU, NCCL on the card), one torch
    thread a rank.  ``fn`` must be importable (a module-level function).
    Raises if any rank fails."""
    import torch.multiprocessing as mp
    if init_method is None:
        fd, path = tempfile.mkstemp(prefix="repro_torch_world_")
        os.close(fd)
        os.unlink(path)
        init_method = f"file://{path}"
    mp.spawn(_spawned, args=(fn, world, init_method, device_type, args), nprocs=world,
             join=True)


def _device_mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is available for a {device_type} mesh; pass "
                           "device_type='cpu' to build a CPU mesh")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_host_mesh(model: int = 1, *, device_type: str = "cuda"):
    """A ``("data", "model")`` mesh over the process group's world.

    ``model`` is the size of the model (tensor-parallel) axis; the data axis
    takes the rest.  Runs on the card unless ``device_type="cpu"``; raises
    (never moves to the CPU) when no card is present.  Example::

        mesh = make_host_mesh(model=4)   # 8 ranks -> (2, 4) data x model
    """
    n = dist.get_world_size() if dist.is_initialized() else 1
    if model < 1:
        raise ValueError(f"make_host_mesh: model={model} must be >= 1")
    if n % model != 0:
        raise ValueError(
            f"make_host_mesh: model={model} does not divide the {n} rank(s) of the "
            "process group; pick a model-axis size that divides the world size "
            "(torchrun --nproc-per-node N, or repro_torch.launch.mesh.spawn on "
            "the CPU)")
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: no process group; call "
                           "repro_torch.launch.mesh.init_world or ensure_world first")
    return _device_mesh(device_type, (n // model, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    n = dist.get_world_size() if dist.is_initialized() else 0
    if n != need:
        raise ValueError(f"make_production_mesh: a {shape} mesh needs a world of {need} "
                         f"ranks, the process group has {n}")
    return _device_mesh(device_type, shape, axes)
