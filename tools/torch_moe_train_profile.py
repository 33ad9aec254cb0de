#!/usr/bin/env python3
"""What fine-tuning the moe and vlm families costs on one NVIDIA GPU, at full
width.

    python3 tools/torch_moe_train_profile.py [--layers N] [--steps N]

Prints the card (``nvidia-smi``), then one JSON line a measurement:

- the cores backward over an expert stack (``mpo_linear_bwd_cores``, bf16)
  at phi3.5-moe-42b-a6.6b's w_up and w_down (4096 <-> 6400, 16 experts, 320
  rows an expert: a 4 x 512 batch's capacity at top-2, factor 1.25) and
  llama4-maverick-400b-a17b's w_up (5120 -> 8192, 128 experts, 20 rows an
  expert), and the stacked forward at the same rows: the card's time of one
  call (CUDA events, L2 flushed), its launch sets and scratch against E
  float32 dWs;
- full-width phi3.5-moe at ``--layers`` layers (default 1), bf16,
  ``finetune(mode="lfa", seq_len=512, batch_size=4)``: one warm-up step,
  then ``--steps`` (default 3) timed, ms a step, peak memory, the MPO
  parameters a layer and the launches a step of each kernel; then one step
  traced with ``torch.profiler``: wall and device busy ms, the device's
  idle share and the kernels by device time;
- full-width llava-next-34b at ``--layers`` layers, bf16, LFA at 4 x (1024
  patches + 128 tokens): one warm-up step, one traced step, as above;
- one llava-next-34b FFN matrix (7168 -> 20480) decomposed on the card by
  ``convert._decompose_to_shapes`` (Algorithm 1), seconds and relative
  error; from it ``Session.from_dense`` seconds at a depth are reckoned;
- the SVDs Algorithm 1 takes at llava's vocabulary matrices (their first
  two unfoldings, random): cuSOLVER's ``gesvd`` called directly (it
  refuses the first) and ``mpo._svd``, which takes these through a QR of
  the long side, seconds and reconstruction error each.

Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

PHI35, LLAMA4, LLAVA = "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b", "llava-next-34b"
SEQ, BATCH = 512, 4


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_moe_train_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import Session, configs
    from repro_torch.core import convert
    from repro_torch.core.layers import cores_to_list
    from repro_torch.kernels import mpo_linear as MK
    from repro_torch.models import transformer as TR
    from repro_torch.timing import device_ms
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)

    def shapes_of(cfg, name):
        with torch.device("meta"):
            layer = TR.init_layer(torch.Generator(), cfg)
        node = layer["moe"]["experts"] if name.startswith("w_") and cfg.family == "moe" \
            else layer["mlp"]
        return [tuple(c.shape) for c in cores_to_list(node[name]["cores"])]

    # the stacked cores backward and forward at the training rows
    for arch, name in ((PHI35, "w_up"), (PHI35, "w_down"), (LLAMA4, "w_up")):
        cfg = configs.get_config(arch)
        shapes = shapes_of(cfg, name)
        e = shapes[0][0]
        rows = BATCH * max(4, int(cfg.capacity_factor * SEQ * cfg.top_k / e))
        i_dim = math.prod(s[2] for s in shapes)
        j_dim = math.prod(s[3] for s in shapes)
        sigma = (1.0 / i_dim / math.prod(s[4] for s in shapes[:-1])) ** (1 / (2 * len(shapes)))
        cores = [(sigma * torch.randn(s, generator=g, device=dev)).bfloat16() for s in shapes]
        x = torch.randn(e, rows, i_dim, generator=g, device=dev).bfloat16()
        dy = torch.randn(e, rows, j_dim, generator=g, device=dev).bfloat16()
        torch.cuda.reset_peak_memory_stats()
        bwd_ms = device_ms(lambda: MK.mpo_linear_bwd_cores(cores, x, dy), flush, 3)
        peak = torch.cuda.max_memory_allocated()
        fwd_ms = device_ms(lambda: MK.mpo_linear(cores, x), flush, 3)
        plan = MK._bwd_plan(tuple(s[1:] for s in shapes), "bfloat16",
                            torch.cuda.get_device_properties(0).multi_processor_count)
        print(json.dumps(dict(
            step="stacked cores backward", arch=arch, matrix=name, experts=e, rows=rows,
            bwd_ms=bwd_ms, fwd_ms=fwd_ms, launch_sets=MK.mpo_linear_bwd_cores.launch_sets,
            workspace_bytes=MK.mpo_linear_bwd_cores.workspace_bytes,
            workspace_per_expert=plan.workspace, dw_f32_bytes_all_experts=4 * e * i_dim * j_dim,
            peak_mem_bytes=peak)), flush=True)
        del cores, x, dy
        torch.cuda.empty_cache()

    def traced(what, sess, ft):
        """One LFA step under ``torch.profiler``: wall, device busy (the
        kernels' summed time), idle share, the kernels by device time."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pt:
            t0 = time.perf_counter()
            sess.finetune(steps=1, seed=2, **ft)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in pt.key_averages() if e.device_type == DeviceType.CUDA]
        dev = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
        print(json.dumps(dict(
            step=f"{what} traced", layers=args.layers, wall_ms=1e3 * wall, device_ms=dev,
            idle_share=1 - dev / (1e3 * wall),
            top=[{"name": e.key[:90], "calls": e.count,
                  "device_ms": e.self_device_time_total / 1e3} for e in top])), flush=True)

    # full-width phi3.5-moe LFA at --layers layers
    sess = Session.init(PHI35, smoke=False, seed=0, num_layers=args.layers)
    per_layer = sum(t.numel() for k, t in sess.model.state_dict().items()
                    if k.startswith("layers.") and ".cores." in k) / args.layers
    experts = sum(t.numel() for k, t in sess.model.state_dict().items()
                  if ".experts." in k and ".cores." in k) / args.layers
    ft = dict(mode="lfa", seq_len=SEQ, batch_size=BATCH, log_every=1)
    sess.finetune(steps=1, seed=1, **ft)
    counts = ((MK.mpo_linear_mma, "launches"), (MK.mpo_linear_mma, "stacked_launches"),
              (MK.mpo_linear_bwd_cores, "launches"), (MK.mpo_linear_bwd_cores, "stacked_launches"),
              (MK.mpo_linear_plain, "calls"), (MK.mpo_linear_bwd_cores_plain, "calls"),
              (MK.mpo_linear_cuda_core, "launches"))
    for fn, attr in counts:
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = sess.finetune(steps=args.steps, seed=0, **ft)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    print(json.dumps(dict(
        step="phi3.5-moe lfa", layers=args.layers, seq_len=SEQ, batch=BATCH, steps=args.steps,
        ms_per_step=1e3 * s / args.steps, peak_mem_bytes=torch.cuda.max_memory_allocated(),
        mpo_params_per_layer=per_layer, expert_params_per_layer=experts,
        trainable=rep["trainable"], total=rep["total"],
        losses=[h["loss"] for h in rep["history"]], aux=[h["aux"] for h in rep["history"]],
        launches_per_step={f"{fn.__name__}.{attr}": getattr(fn, attr) / args.steps
                           for fn, attr in counts})), flush=True)
    traced("phi3.5-moe lfa", sess, ft)
    del sess
    torch.cuda.empty_cache()
    sess = Session.init(LLAVA, smoke=False, seed=0, num_layers=args.layers)
    vft = dict(mode="lfa", seq_len=sess.cfg.frontend_len + 128, batch_size=BATCH, log_every=1)
    sess.finetune(steps=1, seed=1, **vft)
    traced("llava-next-34b lfa", sess, vft)
    del sess
    torch.cuda.empty_cache()

    # one llava FFN matrix through Algorithm 1 on the card
    cfg = configs.get_config(LLAVA)
    shapes = shapes_of(cfg, "w_up")
    w = torch.randn(cfg.d_model, cfg.d_ff, generator=g, device=dev) / math.sqrt(cfg.d_model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cores = convert._decompose_to_shapes(w, shapes)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    from repro_torch.core import mpo
    err = float(torch.linalg.norm(mpo.reconstruct(cores) - w) / torch.linalg.norm(w))
    print(json.dumps(dict(step="llava from_dense matrix", matrix="w_up", shape=[cfg.d_model,
                          cfg.d_ff], core_shapes=shapes, seconds=s, rel_err=err)), flush=True)
    del w, cores
    torch.cuda.empty_cache()

    # the vocabulary matrices' unfoldings: gesvd alone, and the route mpo._svd takes
    for rows, cols in ((70, 6553600), (112, 4096000), (5120, 81920)):
        a = torch.randn(rows, cols, generator=g, device=dev)
        rec = {}
        for name, fn in (("gesvd", lambda: torch.linalg.svd(a, full_matrices=False,
                                                             driver="gesvd")),
                         ("mpo._svd", lambda: mpo._svd(a))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                u, sv, vt = fn()
            except RuntimeError as e:           # cuSOLVER's refusal (torch's LinAlgError)
                rec[name] = {"error": str(e)[:160]}
                continue
            torch.cuda.synchronize()
            rec[name] = {"seconds": time.perf_counter() - t0,
                         "rel_err": float(torch.linalg.norm(u @ torch.diag(sv) @ vt - a)
                                          / torch.linalg.norm(a))}
            del u, sv, vt
        print(json.dumps(dict(step="llava vocabulary unfolding svd", shape=[rows, cols],
                              qr_route=rows * cols >= mpo.SVD_QR_ENTRIES, **rec)), flush=True)
        del a
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
