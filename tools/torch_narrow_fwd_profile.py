#!/usr/bin/env python3
"""The float32 forward for the narrow shapes (``csrc/mpo_linear.cu``) at the
full-width matrices that take it, on one NVIDIA GPU.

    python3 tools/torch_narrow_fwd_profile.py [--tiles] [--quick] [--phases]
                                              [--cases LABEL]

For each case (the matrices and rows of ``PERF.md``'s row 1c, gemma2-27b's
w_down at its long prefill's 4352 rows, qwen3-14b's lm_head at a decode
step's 2, whisper-tiny's matrices at its float32 LFA step's and prefill's
rows; ``--cases`` keeps those whose label holds the text) it draws random
cores on the card, checks the kernel against
``mpo_linear_plain`` (float32 tolerance 1e-4 of the largest output, grown
as the root of I past 3072 terms) and two launches bit for bit, and prints
one JSON line: the plan, the kernel's mean device ms (CUDA events, L2
flushed before each call, a GPU spin hiding the host's enqueue), the plain
version's, the library call's (``torch.matmul(x, reconstruct(cores))``) and
the bound (bytes over 3.35 TB/s or operations over float32's 67 TFLOP/s,
the larger).  ``--tiles`` also times other launches at the plan's bond (one
row tile a block at each row tile size and L group, row groups of 2 to all
row tiles at L groups of 1, 4 and 8 stages with as many resident stages as
fit); ``--quick`` skips the plain and library
times; ``--phases`` builds the kernel again with ``-DMPO_NARROW_PROFILE`` and
prints, from one launch of it, each phase's share of its blocks' clock
cycles (R, P, L, the W rebuild, the wait for an x stage, the product, the
partial sums' trips with the epilogue; thread 0 of each block, barrier to
barrier) and the mean cycles a block.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
# (label, arch, path to the matrix in the port's params, smoke, rows, reps)
CASES = (
    ("smoke bert-base wq", "bert-base", ("layers", "attn", "wq"), True, 48, 10),
    ("gemma2-27b w_down", "gemma2-27b", ("layers", "mlp", "w_down"), False, 64, 3),
    ("gemma2-27b w_down", "gemma2-27b", ("layers", "mlp", "w_down"), False, 4352, 3),
    ("zamba2-7b shared wq", "zamba2-7b", ("shared_attn", "attn", "wq"), False, 128, 10),
    ("whisper-tiny attention", "whisper-tiny", ("encoder", "attn", "wq"), False, 8, 10),
    ("whisper-tiny attention", "whisper-tiny", ("encoder", "attn", "wq"), False, 12000, 3),
    ("whisper-tiny w_up", "whisper-tiny", ("encoder", "mlp", "w_up"), False, 8, 10),
    ("whisper-tiny w_up", "whisper-tiny", ("encoder", "mlp", "w_up"), False, 12000, 3),
    ("whisper-tiny w_down", "whisper-tiny", ("encoder", "mlp", "w_down"), False, 8, 10),
    ("whisper-tiny w_down", "whisper-tiny", ("encoder", "mlp", "w_down"), False, 12000, 3),
    ("qwen3-14b lm_head", "qwen3-14b", ("lm_head",), False, 2, 3),
    # whisper-tiny at the rows its float32 paths give: an LFA step's 2 x 448
    # tokens and a prefill's 2 x 1500 frames
    ("whisper-tiny attention", "whisper-tiny", ("encoder", "attn", "wq"), False, 896, 10),
    ("whisper-tiny attention", "whisper-tiny", ("encoder", "attn", "wq"), False, 3000, 10),
    ("whisper-tiny w_up", "whisper-tiny", ("encoder", "mlp", "w_up"), False, 896, 10),
    ("whisper-tiny w_up", "whisper-tiny", ("encoder", "mlp", "w_up"), False, 3000, 10),
    ("whisper-tiny w_down", "whisper-tiny", ("encoder", "mlp", "w_down"), False, 896, 10),
    ("whisper-tiny w_down", "whisper-tiny", ("encoder", "mlp", "w_down"), False, 3000, 10),
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--cases", default="", help="only the cases whose label holds this")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_narrow_fwd_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.core import mpo
    from repro_torch.core.layers import cores_to_list
    from repro_torch.kernels import mpo_linear as MK
    from repro_torch.models import model as TModel
    from repro_torch.timing import device_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    lib = MK._lib()
    plib = _phases_lib(MK) if args.phases else None
    for label, arch, path, smoke, m, reps in CASES:
        if args.cases not in label:
            continue
        cfg = configs.smoke_config(arch) if smoke else configs.get_config(arch)
        with torch.device("meta"):
            node = TModel.family_module(cfg).init(torch.Generator(), cfg)
        for k in path:
            node = node[k]
        shapes = tuple(tuple(c.shape[-4:]) for c in cores_to_list(node["cores"]))
        assert MK.forward_kernel(shapes, "float32") == "cuda_core", label
        i_dim = math.prod(c[1] for c in shapes)
        j_dim = math.prod(c[2] for c in shapes)
        sigma = (1.0 / i_dim / math.prod(c[3] for c in shapes[:-1])) ** (1 / (2 * len(shapes)))
        cores = [torch.randn(s, generator=gen, device=dev) * sigma for s in shapes]
        x = torch.randn(m, i_dim, generator=gen, device=dev)
        plan = MK._narrow_plan(shapes, m)
        y = MK.mpo_linear(cores, x)
        again = MK.mpo_linear(cores, x)
        ref = MK.mpo_linear_plain(cores, x)
        torch.cuda.synchronize()
        tol = 1e-4 * math.sqrt(max(i_dim, 3072) / 3072)
        err = (y - ref).abs().max().item()
        scale = ref.abs().max().item()
        del y, ref
        nbytes = 4 * (x.numel() + sum(c.numel() for c in cores) + m * j_dim)
        ops = 2 * m * i_dim * j_dim
        rec = dict(case=label, shapes=[list(s) for s in shapes], M=m, split=plan.split,
                   bm=plan.bm, rg=plan.rg, ch=plan.ch, lq=plan.lq, splits=plan.splits,
                   fast=plan.fast,
                   vec=plan.vec,
                   smem_bytes=plan.smem, workspace_bytes=plan.workspace,
                   max_abs_err=err, scale=scale, tol=tol,
                   ok=bool(err <= tol * scale and torch.equal(again, MK.mpo_linear(cores, x))),
                   kernel_ms=device_ms(lambda: MK.mpo_linear(cores, x), flush, reps),
                   bound_ms=1e3 * max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_S))
        del again
        if args.tiles:
            # the plan's launch and others: one row tile a block with one
            # stage of W (64 and 128 rows), and row groups of 2, 4, 8, 16
            # tiles and all of them with as many resident stages as fit
            dims = MK._dims(shapes)
            g = MK._narrow_geometry(shapes, plan.split)
            ptrs = (ctypes.c_void_p * len(cores))(*[c.data_ptr() for c in cores])
            yt = torch.empty(m, j_dim, device=dev)
            nq = g["nq"]
            variants = {(plan.bm, plan.rg, plan.ch, plan.lq, plan.splits)}
            for bm in MK.NARROW_BM:
                if MK._narrow_smem_bytes(g, bm) > MK.SMEM_LIMIT:
                    continue
                mtiles = -(-m // bm)
                splits = MK._narrow_splits(i_dim, m, g["jtiles"] * mtiles, g["nst"])
                for k in MK.NARROW_LGROUPS:     # one row tile a block, each L group
                    if MK._narrow_smem_bytes(MK._narrow_geometry(shapes, plan.split, k),
                                             bm) <= MK.SMEM_LIMIT:
                        variants.add((bm, 1, 1, k * nq, splits))
                for k in (1, 4, 8):              # row groups at L groups of 1, 4, 8 stages
                    gk = MK._narrow_geometry(shapes, plan.split, k)
                    ch = min(g["nst"], (MK.SMEM_LIMIT - MK._narrow_smem_bytes(gk, bm, 0))
                             // (6 * MK.NARROW_BK * MK.NARROW_WP))
                    for rg in (2, 4, 8, 16, plan.rg, mtiles):
                        if 1 < rg <= mtiles and ch >= 1 and k <= g["nst"]:
                            variants.add((bm, rg, ch, k * nq, 1))
            tiles = {}
            for bm, rg, ch, lq, splits in sorted(variants):
                ws = torch.empty(max(1, splits * m * j_dim if splits > 1 else 1), device=dev)
                run = (lambda bm=bm, rg=rg, ch=ch, lq=lq, splits=splits, ws=ws: lib.mpo_linear_fwd(
                    ptrs, dims, len(cores), plan.split, bm, rg, ch, lq, splits, x.data_ptr(),
                    yt.data_ptr(), m, 1, ws.data_ptr(), torch.cuda.current_stream().cuda_stream))
                if run() != 0:
                    continue
                tiles[f"bm{bm} rg{rg} ch{ch} lq{lq} S{splits}"] = device_ms(run, flush, reps)
                del ws
            rec["tiles_ms"] = tiles
            del yt
        if plib is not None:
            ptrs = (ctypes.c_void_p * len(cores))(*[c.data_ptr() for c in cores])
            yp = torch.empty(m, j_dim, device=dev)
            ws = torch.empty(max(1, plan.workspace // 4), device=dev)
            counters = (ctypes.c_ulonglong * 8)()
            for _ in range(2):                      # the second launch is read
                plib.mpo_linear_fwd_phases(counters)
                rc = plib.mpo_linear_fwd(ptrs, MK._dims(shapes), len(cores), plan.split, plan.bm,
                                         plan.rg, plan.ch, plan.lq, plan.splits, x.data_ptr(),
                                         yp.data_ptr(), m, 1, ws.data_ptr(),
                                         torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                assert rc == 0, rc
            plib.mpo_linear_fwd_phases(counters)
            total = sum(counters[k] for k in range(7)) or 1
            rec["phases"] = {k: counters[i] / total for i, k in enumerate(
                ("R", "P", "L", "rebuild", "x wait", "product", "sums"))}
            rec["cycles_a_block"] = total / max(1, counters[7])
            rec["blocks"] = counters[7]
            del yp, ws
        if not args.quick:
            rec["plain_ms"] = device_ms(lambda: MK.mpo_linear_plain(cores, x), flush, reps)
            rec["library_ms"] = device_ms(lambda: torch.matmul(x, mpo.reconstruct(cores)),
                                          flush, reps)
        print(json.dumps(rec), flush=True)
        del cores, x
        torch.cuda.empty_cache()
        if not rec["ok"]:
            print(f"torch_narrow_fwd_profile: {label} M={m} wrong (err {err}, scale {scale})",
                  file=sys.stderr)
            return 1
    return 0


def _phases_lib(MK):
    """``csrc/mpo_linear.cu`` built with ``-DMPO_NARROW_PROFILE`` beside the
    normal build (``build/kernels/mpo_linear_phases.so``)."""
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / "mpo_linear_phases.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DMPO_NARROW_PROFILE", "-o", str(so),
                    str(_build.CSRC / "mpo_linear.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.mpo_linear_fwd.argtypes = MK._lib().mpo_linear_fwd.argtypes
    lib.mpo_linear_fwd.restype = ctypes.c_int
    lib.mpo_linear_fwd_phases.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.mpo_linear_fwd_phases.restype = ctypes.c_int
    return lib


if __name__ == "__main__":
    sys.exit(main())
