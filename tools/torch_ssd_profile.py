#!/usr/bin/env python3
"""The chunked SSD scan's time by launch and by head group, on one NVIDIA GPU.

    python3 tools/torch_ssd_profile.py          # the forward
    python3 tools/torch_ssd_profile.py --bwd    # the backward

At mamba2-130m's head geometry (24 heads of 64, state 128, chunk 128) and
``chip_smoke.py``'s three prompt shapes (8 x 512, 8 x 100, 1 x 4096), both
dtypes, it times one call of ``csrc/ssd_scan.cu`` on the card and each of
its three launches alone (chunk states, state passing, chunk outputs; CUDA
events, L2 flushed before each call, a GPU spin hiding the host's enqueue),
for every head group the kernel takes (the divisors of 24 up to 8), and
prints one JSON line a case and group, ``planned`` marking the group
``_ssd_plan`` picks.  Each line also holds y's and the final state's error
against the plain version, relative to their largest magnitudes.

``--bwd`` does the same for the backward (``csrc/ssd_scan_bwd.cu``) at
``chip_smoke.py`` phase 11's shapes (4 x 512, the training shape; 8 x 512,
8 x 100, 1 x 4096), a random final-state cotangent: one call and each of
its four launches alone (d(prev), the reverse state pass, the chunk
gradients, the sums across blocks), from the forward's scratch, at every
head group whose shared memory fits, with each gradient's error against
``ssd_scan_bwd_plain`` relative to its largest magnitude.  Exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

H, P, N, CHUNK = 24, 64, 128, 128
CASES = ((8, 512), (8, 100), (1, 4096))
BWD_CASES = ((4, 512), (8, 512), (8, 100), (1, 4096))
GRADS = ("dx", "ddt", "da_log", "db", "dc", "dd_skip")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bwd", action="store_true", help="time the backward kernel")
    bwd = ap.parse_args().bwd
    import torch

    if not torch.cuda.is_available():
        print("torch_ssd_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels.mpo_linear import _sm_count
    from repro_torch.timing import device_ms
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def timed(fn):
        return device_ms(fn, flush)

    for bs, s in BWD_CASES if bwd else ():
        for dtype in ("bfloat16", "float32"):
            tdt = getattr(torch, dtype)
            x = torch.randn(bs, s, H, P, generator=gen).to(dev, tdt)
            dt = torch.nn.functional.softplus(torch.randn(bs, s, H, generator=gen) - 4).to(dev)
            a_log = (0.5 * torch.randn(H, generator=gen)).to(dev)
            b = (0.3 * torch.randn(bs, s, N, generator=gen)).to(dev, tdt)
            c = (0.3 * torch.randn(bs, s, N, generator=gen)).to(dev, tdt)
            d_skip = (1 + 0.1 * torch.randn(H, generator=gen)).to(dev)
            dy = torch.randn(bs, s, H, P, generator=gen).to(dev, tdt)
            d_final = torch.randn(bs, H, N, P, generator=gen).to(dev)
            args = (x, dt, a_log, b, c, d_skip)
            fws = SSD._forward(*args, CHUNK)[2]
            ref = SSD.ssd_scan_bwd_plain(*args, dy, d_final, CHUNK)
            q = min(CHUNK, s)
            plan = SSD._ssd_bwd_plan(bs, s, H, P, N, q, dtype, _sm_count(0))
            grads = tuple(torch.empty_like(t) for t in args)
            for group in [g for g in range(1, SSD.SSD_GMAX + 1) if H % g == 0 and
                          max(SSD._ssd_bwd_smem(q, N, P, g, dtype)) <= SSD.SMEM_LIMIT]:
                ws = torch.empty(SSD._ssd_bwd_workspace(bs, s, H, P, N, q, group) // 4,
                                 dtype=torch.float32, device=dev)

                def run(launch, group=group, ws=ws):
                    return lambda: SSD._run_bwd(args, dy, d_final, fws, grads, ws, q, group,
                                                stream, launch)

                if run(0)() != 0:
                    print(f"torch_ssd_profile: backward refused at group {group}",
                          file=sys.stderr)
                    return 1
                torch.cuda.synchronize()
                rec = {"kernel": "ssd_scan_bwd", "B": bs, "S": s, "dtype": dtype,
                       "group": group, "planned": group == plan.group,
                       "rel_err": {n: ((g.float() - r.float()).abs().max()
                                       / r.float().abs().max()).item()
                                   for n, g, r in zip(GRADS, grads, ref)},
                       "ms": timed(run(0)),
                       "launch_ms": [timed(run(k)) for k in range(1, SSD.SSD_BWD_KERNELS + 1)]}
                print(json.dumps(rec), flush=True)

    for bs, s in () if bwd else CASES:
        for dtype in ("bfloat16", "float32"):
            tdt = getattr(torch, dtype)
            x = torch.randn(bs, s, H, P, generator=gen).to(dev, tdt)
            dt = torch.nn.functional.softplus(torch.randn(bs, s, H, generator=gen) - 4).to(dev)
            a_log = (0.5 * torch.randn(H, generator=gen)).to(dev)
            b = (0.3 * torch.randn(bs, s, N, generator=gen)).to(dev, tdt)
            c = (0.3 * torch.randn(bs, s, N, generator=gen)).to(dev, tdt)
            d_skip = (1 + 0.1 * torch.randn(H, generator=gen)).to(dev)
            ry, rstate = SSD.ssd_scan_plain(x, dt, a_log, b, c, d_skip, CHUNK)
            q = min(CHUNK, s)
            plan = SSD._ssd_plan(bs, s, H, P, N, q, dtype, _sm_count(0))
            y = torch.empty_like(x)
            state = torch.empty((bs, H, N, P), dtype=torch.float32, device=dev)
            ws = torch.empty(plan.workspace // 4, dtype=torch.float32, device=dev)
            for group in [g for g in range(1, SSD.SSD_GMAX + 1) if H % g == 0]:
                def run(launch, group=group):
                    return lambda: SSD._run(x, dt, a_log, b, c, d_skip, y, state, ws, q, group,
                                            stream, launch)

                if run(0)() != 0:
                    print(f"torch_ssd_profile: launch refused at group {group}", file=sys.stderr)
                    return 1
                torch.cuda.synchronize()
                rec = {"B": bs, "S": s, "dtype": dtype, "group": group,
                       "planned": group == plan.group,
                       "y_rel_err": ((y.float() - ry.float()).abs().max()
                                     / ry.float().abs().max()).item(),
                       "state_rel_err": ((state - rstate).abs().max()
                                         / rstate.abs().max()).item(),
                       "ms": timed(run(0)),
                       "launch_ms": [timed(run(k)) for k in range(1, SSD.SSD_KERNELS + 1)]}
                print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
