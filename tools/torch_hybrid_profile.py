#!/usr/bin/env python3
"""What serving and fine-tuning the hybrid family costs on one NVIDIA GPU,
at zamba2-7b's full width (weights drawn on the card from seed 0).

    python3 tools/torch_hybrid_profile.py [--fact-layers N] [--train-layers N]

Prints the card (``nvidia-smi``), then one JSON line a measurement:

- the kernels at zamba2-7b's shapes, bf16, against nothing (``chip_smoke.py``
  holds them against their plain versions): the MPO-linear forward at
  in_proj (3584 -> 14576) and out_proj (7168 -> 3584) at 8 x 512 rows, the
  cores backward at the shared w_up (3584 -> 14336) at 2 x 512, the SSD
  scan at 8 x 512 and its backward at 2 x 512 (112 heads of 64, state 64):
  the card's time of one call (CUDA events, L2 flushed);
- all 81 layers, bf16, ``serve(8, 544)`` from 8 x 512 prompts with the
  weight cache, 16 tokens: init and ``cache_weights`` seconds, prefill ms,
  decode ms a step, peak memory, launches; the same factorized at
  ``--fact-layers`` (default 27);
- ``finetune(mode="lfa", seq_len=512, batch_size=2)`` at ``--train-layers``
  (default 27): one warm-up step, 2 timed, ms a step, peak memory,
  launches a step;
- ``Session.from_dense`` of an exact tree at 9 layers and one squeeze
  iteration (a 1-step re-tune): seconds each.

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

ARCH, BATCH, PROMPT, MAX_LEN, NEW = "zamba2-7b", 8, 512, 544, 16
TRAIN_BATCH, TRAIN_SEQ = 2, 512


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fact-layers", type=int, default=27)
    ap.add_argument("--train-layers", type=int, default=27)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_hybrid_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import Session, configs
    from repro_torch.core import lightweight, mpo
    from repro_torch.core.layers import cores_to_list
    from repro_torch.kernels import _build
    from repro_torch.kernels import mpo_linear as MK
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.timing import device_ms
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _build.build()
    emit(step="build", s=time.perf_counter() - t0)
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    cfg = configs.get_config(ARCH)

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    def counts():
        return {"mpo_linear_fwd_mma": MK.mpo_linear_mma.launches,
                "mpo_linear_fwd": MK.mpo_linear_cuda_core.launches,
                "mpo_linear_bwd_cores": MK.mpo_linear_bwd_cores.launches,
                "ssd_scan": SSD.ssd_scan.launches, "ssd_scan_bwd": SSD.ssd_scan_bwd.launches,
                "plain": MK.mpo_linear_plain.calls + MK.mpo_linear_bwd_cores_plain.calls
                + SSD.ssd_scan_plain.calls + SSD.ssd_scan_bwd_plain.calls}

    def zero():
        for fn, attr in ((MK.mpo_linear_mma, "launches"), (MK.mpo_linear_cuda_core, "launches"),
                         (MK.mpo_linear_bwd_cores, "launches"), (SSD.ssd_scan, "launches"),
                         (SSD.ssd_scan_bwd, "launches"), (MK.mpo_linear_plain, "calls"),
                         (MK.mpo_linear_bwd_cores_plain, "calls"), (SSD.ssd_scan_plain, "calls"),
                         (SSD.ssd_scan_bwd_plain, "calls")):
            setattr(fn, attr, 0)

    # the kernels at the path's shapes, one layer of a 9-layer model
    src = Session.init(dataclasses.replace(cfg, num_layers=9), seed=0, init_device="cuda")
    mats = {"in_proj": ("mamba", "in_proj"), "out_proj": ("mamba", "out_proj"),
            "w_up": ("shared_attn", "mlp", "w_up")}
    for name, path in mats.items():
        node = src.params
        for k in path:
            node = node[k]
        cores = [c[0].to(torch.bfloat16).contiguous() for c in cores_to_list(node["cores"])]
        i_dim = int(np.prod([c.shape[1] for c in cores]))
        j_dim = int(np.prod([c.shape[2] for c in cores]))
        m = BATCH * PROMPT
        x = torch.randn(m, i_dim, generator=g, device=dev).to(torch.bfloat16)
        rec = {"kernel": "mpo_linear_fwd_mma", "matrix": name, "M": m,
               "ms": device_ms(lambda: MK.mpo_linear(cores, x), flush, 5)}
        if name == "w_up":
            xt = x[:TRAIN_BATCH * TRAIN_SEQ]
            dy = torch.randn(xt.shape[0], j_dim, generator=g, device=dev).to(torch.bfloat16)
            rec["bwd_ms"] = device_ms(lambda: MK.mpo_linear_bwd_cores(cores, xt, dy), flush, 5)
        emit(step="kernel", **rec)
    del src
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    for bs in (BATCH, TRAIN_BATCH):
        x = torch.randn(bs, PROMPT, h, p, generator=g, device=dev).to(torch.bfloat16)
        dt = torch.nn.functional.softplus(torch.randn(bs, PROMPT, h, generator=g,
                                                      device=dev) - 4)
        a_log = 0.5 * torch.randn(h, generator=g, device=dev)
        b = (0.3 * torch.randn(bs, PROMPT, n, generator=g, device=dev)).to(torch.bfloat16)
        c = (0.3 * torch.randn(bs, PROMPT, n, generator=g, device=dev)).to(torch.bfloat16)
        d = torch.ones(h, device=dev)
        args_ = (x, dt, a_log, b, c, d)
        rec = {"kernel": "ssd_scan", "B": bs, "S": PROMPT,
               "ms": device_ms(lambda: SSD.ssd_scan(*args_, cfg.ssm_chunk), flush, 5)}
        if bs == TRAIN_BATCH:
            fws = SSD._forward(*args_, cfg.ssm_chunk)[2]
            rec["bwd_ms"] = device_ms(lambda: SSD.ssd_scan_bwd(*args_, x, None, fws,
                                                               cfg.ssm_chunk), flush, 5)
        emit(step="kernel", **rec)
    torch.cuda.empty_cache()

    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(
        np.int32)

    def serve(sess, wc, what):
        handle = sess.serve(BATCH, MAX_LEN, weight_cache=wc)
        handle.generate({"tokens": prompts}, 2)
        handle.reset()
        torch.cuda.reset_peak_memory_stats()
        zero()
        t0 = clock()
        logits = handle.prefill({"tokens": prompts})
        t1 = clock()
        pre = counts()
        zero()
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        for _ in range(NEW - 1):
            tok, _ = handle.decode(tok)
        t2 = clock()
        emit(step="serve", what=what, layers=sess.cfg.num_layers, weight_cache=wc,
             init_s=handle.init_seconds, prefill_ms=1e3 * (t1 - t0),
             decode_ms_per_step=1e3 * (t2 - t1) / (NEW - 1),
             peak_mem_bytes=torch.cuda.max_memory_allocated(), launches_prefill=pre,
             launches_decode=counts(),
             finite=bool(torch.isfinite(logits).all()))
        sess._serve.clear()

    torch.cuda.reset_peak_memory_stats()
    t0 = clock()
    sess = Session.init(cfg, seed=0, init_device="cuda")
    emit(step="init", layers=cfg.num_layers, s=clock() - t0,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         params_bytes=sum(t.numel() * t.element_size() for t in lightweight.leaves(sess.params)))
    serve(sess, True, "cached")
    del sess
    torch.cuda.empty_cache()
    sess = Session.init(dataclasses.replace(cfg, num_layers=args.fact_layers), seed=0,
                        init_device="cuda")
    serve(sess, False, "factorized")
    del sess
    torch.cuda.empty_cache()

    sess = Session.init(dataclasses.replace(cfg, num_layers=args.train_layers), seed=0,
                        init_device="cuda")
    ft = dict(mode="lfa", seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, log_every=1)
    t0 = clock()
    sess.finetune(steps=1, seed=1, **ft)
    warm = clock() - t0
    torch.cuda.reset_peak_memory_stats()
    zero()
    t0 = clock()
    rep = sess.finetune(steps=2, seed=0, **ft)
    emit(step="finetune", layers=args.train_layers, warmup_s=warm,
         ms_per_step=1e3 * (clock() - t0) / 2, peak_mem_bytes=torch.cuda.max_memory_allocated(),
         launches_per_step={k: v / 2 for k, v in counts().items()},
         losses=[h["loss"] for h in rep["history"]], trainable=rep["trainable"],
         total=rep["total"])
    del sess
    torch.cuda.empty_cache()

    lcfg = dataclasses.replace(cfg, num_layers=9)
    src = Session.init(lcfg, seed=0, init_device="cuda")

    def exact(tree):
        if "cores" in tree:
            return {"w": mpo.reconstruct_stacked(cores_to_list(tree["cores"]))}
        return {k: exact(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}

    dense = exact(src.params)
    del src
    t0 = clock()
    life = Session.from_dense(dense, lcfg)
    conv = clock() - t0
    del dense
    rep = life.report()
    t0 = clock()
    evs = life.squeeze(step=1, max_iters=1, finetune_steps=1, seq_len=TRAIN_SEQ,
                       batch_size=TRAIN_BATCH, delta=1.0)
    emit(step="lifecycle", layers=9, from_dense_s=conv,
         conversion_max_rel_err=rep["conversion_max_rel_err"], squeeze_s=clock() - t0,
         events=[(e.layer, e.bond, e.new_dim, e.seconds) for e in evs])
    return 0


def emit(**kw):
    print(json.dumps(kw, default=str), flush=True)


if __name__ == "__main__":
    sys.exit(main())
