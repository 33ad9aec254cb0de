#!/usr/bin/env python3
"""Where the MPO-linear cores backward's time goes, launch by launch, on one
NVIDIA GPU.

    python3 tools/torch_bwd_profile.py

At bert-base's attention and w_up matrices (random cores, 2048 rows: the
16 x 128 tokens of a fine-tuning step), both dtypes, it times one call of
``mpo_linear_bwd_cores`` on the card (CUDA events, L2 flushed before each
call, a GPU spin hiding the host's enqueue) and traces five calls with
``torch.profiler``, printing one JSON line a case: the call's ms and the
mean device microseconds of its three launches (chains, tile pass,
epilogue), for every core (``all``), the prefix cores only (no dR share in
the tile pass, no suffix pullback: ``prefix``) and the suffix cores only
(no dL: ``suffix``).  Exits non-zero without a card.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

M = 2048
MATRICES = {  # bert-base's core shapes (repro_torch/configs/bert_base.py)
    "attn": [(1, 3, 3, 9), (9, 4, 4, 64), (64, 4, 4, 64), (64, 4, 4, 16), (16, 4, 4, 1)],
    "w_up": [(1, 3, 6, 18), (18, 4, 8, 64), (64, 4, 4, 64), (64, 4, 4, 16), (16, 4, 4, 1)],
}


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_bwd_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import mpo_linear as MK
    from repro_torch.timing import device_ms
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)

    def timed(fn):
        return device_ms(fn, flush)

    for name, shapes in MATRICES.items():
        n = len(shapes)
        s = MK._bwd_plan(tuple(shapes)).split
        i_dim = math.prod(c[1] for c in shapes)
        j_dim = math.prod(c[2] for c in shapes)
        cores32 = [torch.randn(c, generator=gen) * 0.35 for c in shapes]
        x32 = torch.randn(M, i_dim, generator=gen)
        dy32 = torch.randn(M, j_dim, generator=gen)
        for dtype in (torch.bfloat16, torch.float32):
            cores = [c.to(dev, dtype) for c in cores32]
            x, dy = x32.to(dev, dtype), dy32.to(dev, dtype)
            for which, needs in (("all", [True] * n), ("prefix", [k < s for k in range(n)]),
                                 ("suffix", [k >= s for k in range(n)])):
                def call():
                    return MK.mpo_linear_bwd_cores(cores, x, dy, needs)

                ms = timed(call)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        call()
                    torch.cuda.synchronize()
                ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                            key=lambda e: e.time_range.start)
                us = [sum(e.time_range.elapsed_us() for e in ev[k::MK.BWD_KERNELS]) / 5
                      for k in range(MK.BWD_KERNELS)] if len(ev) == 5 * MK.BWD_KERNELS else None
                print(json.dumps({"matrix": name, "dtype": str(dtype).split(".")[1],
                                  "M": M, "cores": which, "ms": ms,
                                  "chains_tiles_epilogue_us": us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
