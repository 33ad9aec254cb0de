#!/usr/bin/env python3
"""Where the time goes on the port's serving and fine-tuning paths, on one
NVIDIA GPU.

    python3 tools/torch_serve_profile.py                      # serving bert-base
    python3 tools/torch_serve_profile.py --arch mamba2-130m   # serving mamba2-130m
    python3 tools/torch_serve_profile.py --train              # one LFA fine-tuning step

Serving: full-width bert-base (bfloat16, 8 prompts of 128 tokens, paged KV
cache, ``serve(8, 256)``) or mamba2-130m (bfloat16, 8 prompts of 512 tokens,
``serve(8, 544)``) with the weight cache and factorized through the
MPO-linear kernel.  After a warm-up generation it traces one prefill and
``STEPS`` decode steps with ``torch.profiler`` and prints, per run, one
JSON line: host wall time per prefill and per decode step, device busy time
(the sum of kernel times) and the device's idle share, and the kernels that
take the most device time.

``--train``: full-width bert-base LFA fine-tuning at 16 x 128 tokens
(``Session.finetune``), one warm-up step, then one traced step: wall time,
device busy time, idle share and the kernels by device time.

Exits non-zero without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

STEPS = 4
# arch -> (prompt tokens, serve max_len, paged KV cache)
SERVE = {"bert-base": (128, 256, True), "mamba2-130m": (512, 544, False)}


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


def _train(s) -> None:
    """One traced LFA fine-tuning step of ``s`` after one warm-up step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ft = dict(mode="lfa", seq_len=128, batch_size=16, steps=1, log_every=1)
    s.finetune(seed=1, **ft)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pt:
        t0 = time.perf_counter()
        s.finetune(**ft)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = _device_ms(pt)
    print(json.dumps({"train_step": "bert-base lfa 16x128 bfloat16", "wall_ms": 1e3 * wall,
                      "device_ms": dev, "idle_share": 1 - dev / (1e3 * wall),
                      "top": _top(pt, 16)}), flush=True)


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import Session
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    argv = sys.argv[1:]
    arch = argv[argv.index("--arch") + 1] if "--arch" in argv else "bert-base"
    s = Session.init(arch, smoke=False, seed=0)
    if "--train" in argv:
        _train(s)
        return 0
    prompt, max_len, paged = SERVE[arch]
    prompts = np.random.default_rng(0).integers(0, s.cfg.vocab_size, (8, prompt))
    for wc in (True, False):
        h = s.serve(8, max_len, paged=paged, weight_cache=wc)
        h.generate({"tokens": prompts}, 4)                  # warm-up
        h.reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pp:
            t0 = time.perf_counter()
            logits = h.prefill({"tokens": prompts})
            torch.cuda.synchronize()
            prefill_wall = time.perf_counter() - t0
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        h.decode(tok)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pd:
            t0 = time.perf_counter()
            for _ in range(STEPS):
                tok, _ = h.decode(tok)
            torch.cuda.synchronize()
            decode_wall = (time.perf_counter() - t0) / STEPS
        dev_prefill, dev_decode = _device_ms(pp), _device_ms(pd) / STEPS
        print(json.dumps({
            "arch": arch, "weight_cache": wc, "prefill_wall_ms": 1e3 * prefill_wall,
            "prefill_device_ms": dev_prefill,
            "prefill_idle_share": 1 - dev_prefill / (1e3 * prefill_wall),
            "decode_wall_ms_per_step": 1e3 * decode_wall,
            "decode_device_ms_per_step": dev_decode,
            "decode_idle_share": 1 - dev_decode / (1e3 * decode_wall),
            "prefill_top": _top(pp), "decode_top": _top(pd)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
