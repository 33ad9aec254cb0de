#!/usr/bin/env python3
"""Accuracy and time of the lifecycle's numerics on one NVIDIA GPU.

    python3 tools/torch_lifecycle_profile.py

1. Algorithm 1 on full-width bert-base's exact tree (the reconstructions of
   a random MPO init, rank <= the bonds): ``convert_dense_to_mpo`` with each
   cuSOLVER SVD driver (``gesvdj``, ``gesvd``, ``gesvda``) and with the
   host's LAPACK on copied tensors, printing each matrix's relative
   reconstruction error and the conversion's seconds (a driver that fails
   to converge is reported as such).
2. The spectra sweep of one squeeze iteration (``bond_spectra`` of every
   matrix of the converted tree, one batched call each) with each cuSOLVER
   driver and with the host's LAPACK on copied cores: seconds (the second
   of two sweeps) and the largest error against a float64 sweep.
3. The MPO-linear forward at M = 8 (a decode step: 16-row tiles, I split
   across blocks) and 2048 in both dtypes against a float64 product
   ``x @ reconstruct(cores)``, beside the plain version's error, and its
   device ms, at the embedding W (I = 30720; bond 1 as configured, 40, and
   squeezed, 39), its transpose (the tied head, I = 768) and w_up (I = 768).
4. float32 mamba2-130m served factorized and with the weight cache, as
   ``chip_smoke.py`` phase 4 serves it (8 prompts of 512 tokens, seed 0),
   the decode teacher-forced with the weight-cached run's greedy tokens:
   each step's largest logit difference between the two runs, the cached
   run's least top-2 margin, and the (slot, step) where the greedy tokens
   differ; before it, the forward against float64 at each of its
   projections (layer 0), float32, M = 8 and 4096.

One JSON line a case.  Exits non-zero without a card.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

MS = (8, 2048)
DRIVERS = ("gesvdj", "gesvd", "gesvda", "cpu")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_lifecycle_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import Session
    from repro_torch.core import convert, mpo
    from repro_torch.core.squeeze import find_mpo_layers
    from repro_torch.core.layers import cores_to_list
    from repro_torch.core.lightweight import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)

    def exact(tree):
        if "cores" in tree:
            return {"w": mpo.reconstruct_stacked(cores_to_list(tree["cores"]))}
        return {k: exact(v) if isinstance(v, dict) else v for k, v in tree.items()}

    src = Session.init("bert-base", smoke=False, seed=0)
    dense = exact(src.params)
    chosen = mpo.SVD_DRIVER
    torch.linalg.svd(torch.randn(64, 64, device="cuda"))          # cuSOLVER's set-up
    for driver in DRIVERS:
        on_host = driver == "cpu"
        d, tmpl = ((tree_map(lambda t: t.cpu(), dense), tree_map(lambda t: t.cpu(), src.params))
                   if on_host else (dense, src.params))
        mpo.SVD_DRIVER = chosen if on_host else driver
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            conv = convert.convert_dense_to_mpo(d, tmpl)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            errs = convert.conversion_error(d, conv)
            rec = {"seconds": secs, "max_rel_err": max(errs.values()), "rel_err": errs}
        except torch.linalg.LinAlgError as e:                       # reported, not hidden
            rec = {"error": str(e)}
        finally:
            mpo.SVD_DRIVER = chosen
        print(json.dumps({"case": "from_dense exact", "driver": driver, **rec}), flush=True)

    layers = [cores_to_list(cd) for cd in
              find_mpo_layers(convert.convert_dense_to_mpo(dense, src.params)).values()]
    ref64 = [mpo.bond_spectra([c.double() for c in cs]) for cs in layers]
    for driver in DRIVERS:
        on_host = driver == "cpu"
        mpo.SVD_DRIVER = chosen if on_host else driver
        try:
            for _ in range(2):                   # the first sweep warms the driver up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = [mpo.bond_spectra([c.cpu() if on_host else c for c in cs])
                       for cs in layers]
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            err = max(((a.to(b.device).double() - b).abs().max() / b.abs().max()).item()
                      for ga, gb in zip(got, ref64) for a, b in zip(ga, gb))
            rec = {"seconds": secs, "max_rel_err_vs_f64": err}
        except torch.linalg.LinAlgError as e:
            rec = {"error": str(e)}
        finally:
            mpo.SVD_DRIVER = chosen
        print(json.dumps({"case": "spectra sweep", "driver": driver, "matrices": len(layers),
                          **rec}), flush=True)

    gen = torch.Generator().manual_seed(0)
    emb = [c.float() for c in cores_to_list(src.params["embed"]["cores"])]
    up = [c[0].float() for c in cores_to_list(src.params["layers"]["mlp"]["w_up"]["cores"])]
    cut = [c.clone() for c in emb]
    cut[1], cut[2] = cut[1][..., :39].contiguous(), cut[2][:39].contiguous()
    for name, cores in (("embed W", emb), ("embed W, bond 1 = 39", cut),
                        ("embed W^T (tied head)", mpo.transpose_cores(emb)), ("w_up W", up)):
        cores = [c.contiguous() for c in cores]
        for m in MS:
            x = torch.randn(m, math.prod(c.shape[1] for c in cores), generator=gen).cuda()
            for dtype in (torch.float32, torch.bfloat16):
                forward_case(name, cores, x, dtype)

    # 4. float32 mamba2-130m: factorized against weight-cached, teacher-forced
    sess = Session.init("mamba2-130m", smoke=False, seed=0, dtype="float32")
    for path, cd in find_mpo_layers(sess.params).items():        # its projections, layer 0
        cores = [(c[0] if c.dim() == 5 else c).contiguous() for c in cores_to_list(cd)]
        for m in (8, 4096):
            x = torch.randn(m, math.prod(c.shape[1] for c in cores), generator=gen).cuda()
            forward_case("mamba2-130m " + "/".join(map(str, path[:-1])), cores, x, torch.float32)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, sess.cfg.vocab_size, (8, 512)).astype(np.int32))
    handles = {wc: sess.serve(8, 544, weight_cache=wc) for wc in (True, False)}
    logits = {wc: h.prefill({"tokens": prompts})[:, -1] for wc, h in handles.items()}
    diffs, margins, flips = [], [], []
    for step in range(32):
        top2 = logits[True].topk(2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).min().item())
        diffs.append((logits[True] - logits[False]).abs().max().item())
        tok = logits[True].argmax(-1)
        flips += [[slot, step] for slot in
                  (tok != logits[False].argmax(-1)).nonzero().flatten().tolist()]
        if step < 31:
            for wc, h in handles.items():
                logits[wc] = h.decode(tok[:, None].to(torch.int32))[1][:, -1]
    print(json.dumps({"case": "mamba2-130m float32 factorized vs cached, teacher-forced",
                      "logits_max_abs_diff_by_step": diffs, "min_top2_margin_by_step": margins,
                      "argmax_differs_at": flips,
                      "scale": logits[True].abs().max().item()}), flush=True)
    return 0


def forward_case(name, cores, x, dtype):
    """One forward case of section 3."""
    import torch

    from repro_torch.core import mpo
    from repro_torch.kernels import mpo_linear as MK
    from repro_torch.timing import device_ms
    flush = torch.empty(64 << 20, device="cuda")                  # 256 MB, beyond the L2
    cs, xx = [c.to(dtype) for c in cores], x.to(dtype)
    ref = xx.double() @ mpo.reconstruct([c.double() for c in cs])
    scale = ref.abs().max().item()
    err = lambda y: (y.double() - ref).abs().max().item() / scale
    print(json.dumps({"case": "forward vs float64", "matrix": name, "M": x.shape[0],
                      "I": xx.shape[-1], "dtype": str(dtype).removeprefix("torch."),
                      "kernel_rel_err": err(MK.mpo_linear(cs, xx)),
                      "plain_rel_err": err(MK.mpo_linear_plain(cs, xx)),
                      "kernel_ms": device_ms(lambda: MK.mpo_linear(cs, xx), flush),
                      "plain_ms": device_ms(lambda: MK.mpo_linear_plain(cs, xx), flush)}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
