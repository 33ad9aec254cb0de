#!/usr/bin/env python3
"""Where serving and fine-tuning the encdec family spend their time on one
NVIDIA GPU, at whisper-tiny's full width and depth (4 encoder and 4 decoder
layers, weights from seed 0).

    python3 tools/torch_encdec_profile.py [--f32-batch N] [--steps N]

Prints the card (``nvidia-smi``), then one JSON line a measurement, in
bfloat16 and in float32:

- ``serve``: ``serve(B, 448)`` from B clips of 1500 frames and 64-token
  prompts (B = 8 in bf16, ``--f32-batch`` in float32, default 2), with the
  weight cache and factorized: after a warm-up generation, one traced
  prefill and ``--steps`` traced decode steps (``torch.profiler``): host
  wall time, device time (the sum of kernel times), the device's idle
  share, the kernels by device time, and the MPO-linear launches;
- ``cross_kv``: the cross-attention's K and V projections over the stored
  encoder output (B x 1500 rows), which a decode step recomputes in every
  decoder layer: the card's time of one projection (CUDA events, L2
  flushed), times the 2 x 4 a step, against the factorized decode step's
  device time;
- ``finetune``: one traced LFA step (``finetune(mode="lfa", seq_len=448)``,
  batch 8 in bf16, ``--f32-batch`` in float32) after a warm-up step: wall
  time, device time, idle share, kernels by device time, launches.

Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ARCH, PROMPT, MAX_LEN, NEW = "whisper-tiny", 64, 448, 16


def _kernels(prof):
    """The device-side (kernel) events only: an operator's device time is
    also booked on its host-side event, so summing both counts it twice."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def _top(prof, n=12):
    rows = sorted(_kernels(prof), key=lambda e: -e.self_device_time_total)
    return [{"name": e.key[:90], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3} for e in rows[:n]]


def _device_ms(prof) -> float:
    return sum(e.self_device_time_total for e in _kernels(prof)) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--f32-batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_encdec_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import Session, configs
    from repro_torch.core import layers as L
    from repro_torch.kernels import _build
    from repro_torch.kernels import mpo_linear as MK
    from repro_torch.models import nn
    from repro_torch.timing import device_ms
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _build.build()
    emit(step="build", s=time.perf_counter() - t0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    def counts():
        return {"mpo_linear_fwd_mma": MK.mpo_linear_mma.launches,
                "mpo_linear_fwd": MK.mpo_linear_cuda_core.launches,
                "mpo_linear_bwd_cores": MK.mpo_linear_bwd_cores.launches,
                "plain": MK.mpo_linear_plain.calls + MK.mpo_linear_bwd_cores_plain.calls}

    def zero():
        for fn, attr in ((MK.mpo_linear_mma, "launches"), (MK.mpo_linear_cuda_core, "launches"),
                         (MK.mpo_linear_bwd_cores, "launches"), (MK.mpo_linear_plain, "calls"),
                         (MK.mpo_linear_bwd_cores_plain, "calls")):
            setattr(fn, attr, 0)

    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(configs.get_config(ARCH), dtype=dtype)
        batch = 8 if dtype == "bfloat16" else args.f32_batch
        rng = np.random.default_rng(5)
        inputs = {"tokens": rng.integers(0, cfg.vocab_size, (batch, PROMPT)).astype(np.int32),
                  "frames": rng.normal(size=(batch, cfg.frontend_len, cfg.d_model))
                  .astype(np.float32)}
        sess = Session.init(cfg, seed=0)
        decode_dev = {}
        for wc in (True, False):
            h = sess.serve(batch, MAX_LEN, weight_cache=wc)
            h.generate(inputs, 3)                      # warm-up
            h.reset()
            zero()
            torch.cuda.synchronize()
            with profile(activities=acts) as pp:
                t0 = time.perf_counter()
                logits = h.prefill(inputs)
                prefill_wall = clock() - t0
            pre = counts()
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            tok, _ = h.decode(tok)
            zero()
            torch.cuda.synchronize()
            with profile(activities=acts) as pd:
                t0 = time.perf_counter()
                for _ in range(args.steps):
                    tok, _ = h.decode(tok)
                decode_wall = (clock() - t0) / args.steps
            dp, dd = _device_ms(pp), _device_ms(pd) / args.steps
            decode_dev[wc] = dd
            emit(step="serve", dtype=dtype, batch=batch, prompt=PROMPT, frames=cfg.frontend_len,
                 max_len=MAX_LEN, weight_cache=wc, prefill_wall_ms=1e3 * prefill_wall,
                 prefill_device_ms=dp, prefill_idle_share=1 - dp / (1e3 * prefill_wall),
                 decode_wall_ms_per_step=1e3 * decode_wall, decode_device_ms_per_step=dd,
                 decode_idle_share=1 - dd / (1e3 * decode_wall), launches_prefill=pre,
                 launches_decode_per_step={k: v / args.steps for k, v in counts().items()},
                 prefill_top=_top(pp), decode_top=_top(pd))
            sess._serve.clear()
            del h
        # the cross K/V a decode step recomputes: wk and wv of each decoder
        # layer over the stored encoder output, as the factorized step runs them
        enc = torch.randn(batch, cfg.frontend_len, cfg.d_model, device="cuda").to(
            cfg.torch_dtype)
        xattn = nn.index_layer(sess.params["decoder"], 0)["xattn"]
        with torch.no_grad():
            one = device_ms(lambda: L.apply_linear(xattn["wk"], enc, cfg=cfg.mpo,
                                                   phase="decode"), flush, 5)
        per_step = 2 * cfg.num_layers * one
        emit(step="cross_kv", dtype=dtype, batch=batch, rows=batch * cfg.frontend_len,
             projection_ms=one, per_decode_step_ms=per_step,
             factorized_decode_device_ms=decode_dev[False],
             share_of_factorized_decode=per_step / decode_dev[False])
        ft = dict(mode="lfa", seq_len=MAX_LEN, batch_size=batch, log_every=1)
        sess.finetune(steps=1, seed=1, **ft)
        zero()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        with profile(activities=acts) as pt:
            t0 = time.perf_counter()
            rep = sess.finetune(steps=1, **ft)
            wall = clock() - t0
        dt = _device_ms(pt)
        emit(step="finetune", dtype=dtype, batch=batch, seq_len=MAX_LEN, wall_ms=1e3 * wall,
             device_ms=dt, idle_share=1 - dt / (1e3 * wall),
             peak_mem_bytes=torch.cuda.max_memory_allocated(), launches=counts(),
             loss=rep["history"][-1]["loss"], trainable=rep["trainable"], total=rep["total"],
             top=_top(pt, 16))
        del sess
        torch.cuda.empty_cache()
    return 0


def emit(**kw):
    print(json.dumps(kw, default=str), flush=True)


if __name__ == "__main__":
    sys.exit(main())
