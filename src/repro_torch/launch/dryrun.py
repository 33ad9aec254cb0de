"""The dry run: one step of a cell, as one rank of a mesh that no machine
here has — the port of ``repro.launch.dryrun``::

    python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
    python -m repro_torch.launch.dryrun --arch bert-base --shape train_4k --mesh 2x4
    python -m repro_torch.launch.dryrun --all --both-meshes --out dryrun.jsonl

The reference lowers and compiles a step for 256 or 512 placeholder
devices.  The port builds its own step under a fake process group
(``torch.testing._internal.distributed.fake_pg.FakeStore``, backend
``"fake"``: collectives return at once) of the mesh's world, as rank 0,
with every tensor a fake one (``FakeTensorMode`` on the CPU device: shapes,
dtypes and placements, nothing allocated), and runs it once: the sharded
LFA train step of ``train.steps.make_train_step`` over DTensor parameters
placed by the production rules (``head_safe_rules(make_rules(mesh))``), or
the mesh serving path's prefill or decode.  The mesh is the production one
(``launch.mesh.make_production_mesh``: 16 x 16, or 2 x 16 x 16 with
``--multi-pod``) or any ``DATAxMODEL`` (``--mesh``).  The placement is
linted first (``analysis.lint_sharding`` at this mesh), as the reference
does.  ``launch.op_analysis`` counts the step per rank (matmul FLOPs,
matmul and written bytes, collective bytes by kind, the peak of live fake
bytes) and ``launch.roofline`` turns the counts into H100 roofline terms.

The train step is ``Session.finetune``'s: the LFA mask, masked AdamW, the
session's loss (classification for a config with ``num_classes``).  Every
family runs: a MoE cell's collectives count its expert parallelism (the
router table's gather and each layer's all-reduce of the combine over
``model``).  Nothing touches a card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig


@contextlib.contextmanager
def fake_world(world: int):
    """A default process group of ``world`` ranks, this process rank 0, on
    the fake backend (no peers, no traffic); torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group already exists in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: tuple | None, *, multi_pod: bool = False):
    """A CPU ``DeviceMesh`` over the fake world: ``shape`` (data, model), or
    the production mesh when None."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_production_mesh
    if shape is None:
        return make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=("data", "model"))


def _batch(cfg, shape: ShapeConfig, *, kind: str) -> dict:
    """A batch of zeros (fake tensors when called under ``FakeTensorMode``)."""
    from repro_torch.data.pipeline import frontend_input
    b, s = shape.global_batch, shape.seq_len
    text = s - (cfg.frontend_len if cfg.family == "vlm" else 0)
    out = {"tokens": torch.zeros((b, 1 if kind == "decode" else text), dtype=torch.int32)}
    if kind == "train":
        out["labels"] = torch.zeros((b,) if cfg.num_classes else (b, s), dtype=torch.int32)
    frontend = frontend_input(cfg)
    if frontend is not None and kind != "decode":
        out[frontend[0]] = torch.zeros((b, cfg.frontend_len, frontend[1]))
    return out


def build_step(cfg, shape: ShapeConfig, mesh):
    """``(step, args, state)`` of one rank's step at ``mesh`` (None: the
    same step on one device, unplaced; call it under ``FakeTensorMode``):
    ``step(*args)`` runs it once, ``state`` is what is live before it
    (parameters, optimizer state, batch, cache)."""
    from repro_torch.core import lightweight
    from repro_torch.models.model import build
    from repro_torch.optim import optimizers
    from repro_torch.parallel import sharding as S
    from repro_torch.train.steps import (TrainState, lm_loss, make_cls_loss,
                                         make_serve_steps, make_train_step)
    model = build(cfg, device="cpu")
    rules = None if mesh is None else S.head_safe_rules(
        S.make_rules(mesh, sp=cfg.parallelism == "sp"), cfg, mesh)
    if shape.kind == "train":
        params = model.tree()
        if mesh is not None:
            params = S.place_tree(params, S.tree_shardings(model.axes, params, mesh, rules),
                                  mesh)
        mask = lightweight.trainable_mask(params, mode="lfa")
        opt = optimizers.adamw(1e-4, mask=mask)
        state = TrainState(params, opt.init(params))
        loss = make_cls_loss(cfg) if cfg.num_classes else (lambda p, b: lm_loss(model, p, b))
        step = make_train_step(model, opt, loss_fn=loss)
        batch = _batch(cfg, shape, kind="train")
        return step, (state, batch), (state, batch)
    prefill, decode, init_serve, _ = make_serve_steps(
        model, mesh=mesh, rules=rules, axes=None if mesh is None else model.axes)
    with torch.no_grad():
        sparams, cache = init_serve(model.tree(), shape.global_batch, shape.seq_len)
    batch = _batch(cfg, shape, kind=shape.kind)

    if shape.kind == "prefill":
        def step(p, b, c):
            with torch.no_grad():
                return prefill(p, b, c)
        return step, (sparams, batch, cache), (sparams, batch, cache)

    def step(p, t, c):
        with torch.no_grad():
            return decode(p, t, c)
    return step, (sparams, batch["tokens"], cache), (sparams, batch, cache)


def model_flops(shape: ShapeConfig, n_active: int) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference), N = active params."""
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch   # decode: one token


def mesh_name(mesh_shape, multi_pod: bool) -> str:
    if mesh_shape is None:
        return "2x16x16" if multi_pod else "16x16"
    return "x".join(str(d) for d in mesh_shape)


def run_cell(arch: str, shape, *, mesh_shape: tuple | None = None, multi_pod: bool = False,
             mpo: bool = True, smoke: bool = False, verbose: bool = True) -> dict:
    """One cell's record: ``shape`` is a ``SHAPES`` name or a
    ``ShapeConfig``; ``mesh_shape`` (data, model), or None for the
    production mesh.  Runs in this process, which must have no process
    group (the fake world is set up and torn down here)."""
    import math

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import format_findings, lint_sharding, summarize
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.launch.roofline import active_param_count, roofline
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = (configs.smoke_config if smoke else configs.get_config)(arch)
    if not mpo:
        cfg = dataclasses.replace(cfg, mpo=dataclasses.replace(cfg.mpo, enabled=False))
    world = math.prod(mesh_shape) if mesh_shape is not None else (512 if multi_pod else 256)
    rec = {"arch": arch, "shape": shape.name, "kind": shape.kind,
           "seq_len": shape.seq_len, "global_batch": shape.global_batch,
           "mesh": mesh_name(mesh_shape, multi_pod), "devices": world, "dtype": cfg.dtype}
    t0 = time.perf_counter()
    with fake_world(world):
        mesh = make_mesh(mesh_shape, multi_pod=multi_pod)
        # static placement lint at this mesh before the step: the
        # head-splitting rule and data-sharded norm leaves surface with
        # provenance
        lint = lint_sharding(cfg, mesh)
        if any(f.severity == "error" for f in lint):
            print(format_findings(lint), file=sys.stderr)
        rec["sharding_lint"] = summarize(lint)
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, args, state = build_step(cfg, shape, mesh)
            _, counts = analyze(step, *args, inputs=state)
        rec.update(
            flops_per_device=counts["flops"],
            flops_by_op=counts["flops_by_op"],
            bytes_per_device=counts["matmul_bytes"],
            bytes_written_per_device=counts["bytes_written"],
            collective_bytes=counts["collective_bytes"],
            peak_bytes_per_device=counts["peak_bytes"],
            ops=counts["ops"])
    rec["seconds"] = time.perf_counter() - t0
    n = active_param_count(cfg)
    dense = dataclasses.replace(cfg, mpo=dataclasses.replace(cfg.mpo, enabled=False))
    rec["model_flops"] = model_flops(shape, n)
    rec["model_flops_dense"] = model_flops(shape, active_param_count(dense))
    rec = roofline(rec)
    if verbose:
        print(json.dumps(rec, default=str))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, help=f"one of {sorted(SHAPES)}")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="a data x model mesh (default: the production mesh)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true", help="the reduced same-family config")
    ap.add_argument("--dense", action="store_true",
                    help="disable MPO (baseline parameterization)")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a, s, skip in configs.cells() if not skip]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    if args.mesh:
        meshes = [(tuple(int(v) for v in args.mesh.lower().split("x")), False)]
    else:
        meshes = [(None, False), (None, True)] if args.both_meshes else [(None, args.multi_pod)]
    records = []
    for arch, shape in cells:
        for mesh_shape, mp in meshes:
            try:
                rec = run_cell(arch, shape, mesh_shape=mesh_shape, multi_pod=mp,
                               mpo=not args.dense, smoke=args.smoke)
            except Exception as e:  # a failing cell is a bug — surface it
                rec = {"arch": arch, "shape": shape, "mesh": mesh_name(mesh_shape, mp),
                       "error": f"{type(e).__name__}: {e}"}
                print(json.dumps(rec), file=sys.stderr)
            records.append(rec)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec, default=str) + "\n")
    n_err = sum(1 for r in records if "error" in r)
    print(f"# dry-run complete: {len(records) - n_err}/{len(records)} cells OK")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
