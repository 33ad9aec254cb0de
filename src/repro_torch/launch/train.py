"""The training entry point — the port of ``repro.launch.train``::

    python -m repro_torch.launch.train --arch qwen3-14b --smoke --steps 3
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch bert-base \\
        --model-parallel 2 --compress int8

Runs over the world it finds: a ``torchrun`` world (one process a card,
NCCL), or a world of one that it sets up in-process (``launch.mesh.
ensure_world``).  The mesh is ``make_host_mesh(model=--model-parallel)``
over that world.  The weights are drawn whole on the host (the seed's
stream, as one device draws it) and each rank puts only its block on its
card (``head_safe_rules(make_rules(mesh, fsdp=False, sp=...))``); each rank
runs its rows of the batch (its ``data`` coordinate's) on its shards and
the gradients are summed over ``data`` (``parallel.spmd``).  ``--device
cpu`` runs the ranks on the CPU (gloo); the default is the card.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import lightweight
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.launch.mesh import ensure_world, make_host_mesh
from repro_torch.models.model import build
from repro_torch.optim import optimizers, schedule
from repro_torch.optim.compress import wrap_compression
from repro_torch.parallel import sharding as S
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.steps import TrainState, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--finetune", choices=["full", "lfa", "central_only"], default="lfa")
    ap.add_argument("--dense", action="store_true", help="disable MPO")
    ap.add_argument("--optimizer", choices=["adamw", "adafactor", "sgdm"], default="adamw")
    ap.add_argument("--compress", choices=["none", "int8", "topk"], default="none")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the ranks' device (cpu: gloo, for tests)")
    args = ap.parse_args(argv)

    cfg = (configs.smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if args.dense:
        cfg = dataclasses.replace(cfg, mpo=dataclasses.replace(cfg.mpo, enabled=False))
    shape = ShapeConfig("cli", "train", args.seq_len, args.batch)

    own_world = ensure_world(args.device)
    try:
        mesh = make_host_mesh(model=args.model_parallel, device_type=args.device)
        device = (torch.device("cuda", torch.cuda.current_device())
                  if args.device == "cuda" else torch.device("cpu"))
        sp = cfg.parallelism == "sp"
        # head-split guard: never tensor-parallel-shard a Q/K/V projection
        # whose head count doesn't divide the model axis
        rules = S.head_safe_rules(S.make_rules(mesh, fsdp=False, sp=sp), cfg, mesh)
        model = build(cfg, device="cpu")           # the host's draw; blocks to the card
        params = model.tree()
        params = S.place_tree(params, S.tree_shardings(model.axes, params, mesh, rules), mesh)
        mask = lightweight.trainable_mask(params, mode=args.finetune)
        tr, tot = lightweight.count_trainable(params, mask)
        print(f"[train] {args.arch} params={tot / 1e6:.2f}M "
              f"trainable={tr / 1e6:.2f}M ({tr / tot:.1%}) "
              f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}")

        sched = schedule.cosine_warmup(args.lr, warmup=min(50, args.steps // 10 + 1),
                                       total=args.steps)
        opt = {"adamw": optimizers.adamw, "adafactor": optimizers.adafactor,
               "sgdm": optimizers.sgdm}[args.optimizer](sched, mask=mask)
        if args.compress != "none":
            opt = wrap_compression(opt, kind=args.compress, mask=mask)
        state = TrainState(params, opt.init(params))
        loop = LoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every)
        state, hist = run_training(
            make_train_step(model, opt), state, make_batch_fn(cfg, shape), loop,
            to_device=lambda b: {k: torch.as_tensor(v).to(device) for k, v in b.items()})
        if hist:
            print(f"[train] final loss {hist[-1]['loss']:.4f}")
        return state, hist
    finally:
        if own_world:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
