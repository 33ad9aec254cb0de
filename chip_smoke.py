#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, each printing JSON lines; any failure exits non-zero:

1. device — the card (as ``nvidia-smi`` names it, with its power limit), the
   torch and CUDA versions, and the seconds the kernel build took (``nvcc``,
   one process per source, into ``build/``).
2. kernels — each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the serving path gives it, with the tolerances
   below; kernel, plain-version and library-yardstick times (CUDA events,
   L2 flushed before every timed launch) and the least time the card could
   take (``bound_ms``).
3. path — full-width bert-base served from 8 prompts of 128 tokens,
   ``serve(8, 256, paged=True)``, 32 generated tokens, once with the weight
   cache and once factorized through the MPO-linear kernel.  Launch counts
   are zeroed just before each run and read just after.
4. parity — float32 bert-base: greedy tokens of paged + factorized, paged +
   weight cache and the dense cache must be identical; then the smoke model
   on the card against the same model on the CPU (plain versions).
5. ``{"kernels": [...]}`` — one entry per kernel of the path.
6. last line: ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
BATCH, PROMPT, MAX_LEN, NEW_TOKENS = 8, 128, 256, 32
# kernel vs plain version on the same inputs.  f32: both sum in f32 in
# another order over up to 3072 terms -> relative 1e-4 of the output's
# largest magnitude.  bf16: both round one f32 value to bf16 once, and the
# other summation order can move it across a rounding boundary -> one bf16
# step (2^-8 relative) at the largest output, doubled.
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# the two bf16 serving runs round W differently (the cached W is rounded to
# bf16 whole, the kernel rebuilds W in f32 from bf16 cores) and 12 layers
# compound it: prefill logits agree within 5e-2 of their largest magnitude
PATH_TOL = 5e-2
# smoke model on the card vs on the CPU, float32 logits
SMOKE_TOL = 1e-4
PEAK_BYTES_S = 3.35e12                           # H100 SXM HBM3
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}   # dense bf16 / f32 non-tensor


def emit(**kw):
    print(json.dumps(kw), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError:
        fail("torch and numpy are needed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    try:
        from repro_torch import Session, configs
        from repro_torch.core import mpo
        from repro_torch.core.layers import cores_to_list
        from repro_torch.kernels import _build
        from repro_torch.kernels import decode_attention as DA
        from repro_torch.kernels import mpo_linear as MK
    except ImportError as e:
        fail(f"the port is not importable next to this script ({e}); run it "
             "from a checkout of the repository")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device + build ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    print(smi, flush=True)
    emit(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s,
         ptxas={n: [ln.strip() for ln in _build.build_log(n).splitlines()
                    if "registers" in ln or "spill" in ln]
                for n in _build.sources()})

    gen = torch.Generator().manual_seed(SEED)
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)

    def timed(fn, reps=10):
        """Mean ms of ``fn`` over ``reps`` launches, L2 flushed before each."""
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            flush_buf.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            total += a.elapsed_time(b)
        return total / reps

    def check(name, out, ref, dtype, extra):
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if not (err <= TOL[dtype] * scale and torch.isfinite(out).all()):
            fail(f"{name} {extra}: max abs err {err} > {TOL[dtype]} x {scale}")
        return err

    # ---- 2. kernels against their plain versions ----
    session = Session.init("bert-base", smoke=False, seed=SEED)
    layer0 = {k: {kk: v[0] for kk, v in lin["cores"].items()}
              for k, lin in session.params["layers"]["attn"].items()}
    layer0.update({k: {kk: v[0] for kk, v in lin["cores"].items()}
                   for k, lin in session.params["layers"]["mlp"].items()})
    mats = {"attn": cores_to_list(layer0["wq"]), "w_up": cores_to_list(layer0["w_up"]),
            "w_down": cores_to_list(layer0["w_down"])}
    results = {}
    for mname, cores32 in mats.items():
        for m in (8, BATCH * PROMPT):
            for dtype in ("bfloat16", "float32"):
                tdt = getattr(torch, dtype)
                cores = [c.to(tdt).contiguous() for c in cores32]
                i_dim = math.prod(c.shape[1] for c in cores)
                j_dim = math.prod(c.shape[2] for c in cores)
                x = torch.randn(m, i_dim, generator=gen).to(dev, tdt)
                y = MK.mpo_linear(cores, x)
                torch.cuda.synchronize()
                ref = MK.mpo_linear_plain(cores, x)
                err = check("mpo_linear_fwd", y, ref, dtype, f"{mname} M={m} {dtype}")
                isz = x.element_size()
                nbytes = isz * (x.numel() + sum(c.numel() for c in cores) + m * j_dim)
                ops = 2 * m * i_dim * j_dim
                w = mpo.reconstruct(cores)
                rec = dict(
                    kernel="mpo_linear_fwd", matrix=mname, shapes=[list(c.shape) for c in cores],
                    M=m, dtype=dtype, max_abs_err=err, tol=TOL[dtype],
                    kernel_ms=timed(lambda: MK.mpo_linear(cores, x)),
                    plain_ms=timed(lambda: MK.mpo_linear_plain(cores, x)),
                    library_ms=timed(lambda: torch.matmul(x, mpo.reconstruct(cores))),
                    dense_matmul_ms=timed(lambda: torch.matmul(x, w)),
                    bound_ms=1e3 * max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[dtype]),
                    bound_by="bytes" if nbytes / PEAK_BYTES_S > ops / PEAK_OPS_S[dtype]
                    else "operations")
                results[("mpo", mname, m, dtype)] = rec
                emit(phase="kernels", **rec)

    def flash_case(kv, g, dh, dtype, softcap, lens):
        tdt = getattr(torch, dtype)
        ps, mp = 16, MAX_LEN // 16
        p = BATCH * mp
        q = torch.randn(BATCH, kv, g, dh, generator=gen).to(dev, tdt)
        kp = torch.randn(p, ps, kv, dh, generator=gen).to(dev, tdt)
        vp = torch.randn(p, ps, kv, dh, generator=gen).to(dev, tdt)
        lens_t = torch.tensor(lens, dtype=torch.int32)
        npg = (lens_t + ps - 1) // ps
        perm = torch.randperm(p, generator=gen).reshape(BATCH, mp).int()
        table = torch.where(torch.arange(mp)[None] < npg[:, None], perm, -1).int()
        bias = torch.where(torch.arange(mp * ps)[None] < lens_t[:, None], 0.0,
                           DA.MASK_VALUE).float()
        table, lens_d, bias = table.to(dev), lens_t.to(dev), bias.to(dev)
        args = (q, kp, vp, table, lens_d, bias)
        out = DA.flash_decode_attention(*args, softcap=softcap)
        torch.cuda.synchronize()
        ref = DA.flash_decode_attention_plain(*args, softcap=softcap)
        err = check("flash_decode_attention", out, ref, dtype,
                    f"KV={kv} G={g} Dh={dh} softcap={softcap}")
        isz = q.element_size()
        keys = int((npg * ps).sum())
        nbytes = (isz * (2 * q.numel() + 2 * keys * kv * dh) + 4 * int(npg.sum())
                  + 4 * BATCH + 4 * keys)
        ops = 4 * kv * g * dh * keys                  # q.k and w.v per key and query head
        library_ms = None
        if not softcap:
            kg = DA.gather_pages(kp, table).transpose(1, 2).contiguous()   # (B, KV, S, Dh)
            vg = DA.gather_pages(vp, table).transpose(1, 2).contiguous()
            valid = torch.arange(mp * ps, device=dev)[None] < (npg.to(dev) * ps)[:, None]
            amask = bias.masked_fill(~valid, float("-inf"))[:, None, None, :].to(tdt)
            library_ms = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kg, vg, attn_mask=amask))
        rec = dict(kernel="flash_decode_attention", KV=kv, G=g, Dh=dh, page_size=ps,
                   lengths=lens, softcap=softcap, dtype=dtype, max_abs_err=err,
                   tol=TOL[dtype],
                   kernel_ms=timed(lambda: DA.flash_decode_attention(*args, softcap=softcap)),
                   plain_ms=timed(lambda: DA.flash_decode_attention_plain(*args,
                                                                          softcap=softcap)),
                   library_ms=library_ms,
                   bound_ms=1e3 * max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[dtype]),
                   bound_by="bytes" if nbytes / PEAK_BYTES_S > ops / PEAK_OPS_S[dtype]
                   else "operations")
        emit(phase="kernels", **rec)
        return rec

    ragged = [0, 1, 17, 128, 129, 200, 255, 256]
    for dtype in ("bfloat16", "float32"):
        flash_case(12, 1, 64, dtype, None, ragged)                 # bert-base geometry
        flash_case(8, 5, 128, dtype, None, ragged)                 # qwen3-14b geometry
        flash_case(8, 5, 128, dtype, 50.0, [5, 1, 0, 33, 129, 64, 250, 16])
        # the serving path's own geometry: every slot at the same length
        results[("flash", "path", dtype)] = flash_case(12, 1, 64, dtype, None,
                                                       [PROMPT + 16] * BATCH)

    # ---- 3. the serving path at full width ----
    counters = ((MK.mpo_linear, "launches"), (DA.flash_decode_attention, "launches"),
                (MK.mpo_linear_plain, "calls"), (DA.flash_decode_attention_plain, "calls"))

    def zero_counts():
        for fn, attr in counters:
            setattr(fn, attr, 0)

    def read_counts():
        return {"mpo_linear_fwd": MK.mpo_linear.launches,
                "flash_decode_attention": DA.flash_decode_attention.launches,
                "mpo_linear_plain": MK.mpo_linear_plain.calls,
                "flash_decode_attention_plain": DA.flash_decode_attention_plain.calls}

    prompts = np.random.default_rng(SEED).integers(
        0, session.cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    path_launches = {"mpo_linear_fwd": 0, "flash_decode_attention": 0}
    prefill_logits = {}
    for wc in (True, False):
        handle = session.serve(BATCH, MAX_LEN, paged=True, weight_cache=wc)
        handle.generate({"tokens": prompts}, 2)         # warm-up, not timed
        handle.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        logits = handle.prefill({"tokens": prompts})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        per_prefill = read_counts()
        zero_counts()
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        out, steps = [tok], []
        for _ in range(NEW_TOKENS - 1):
            tok, step_logits = handle.decode(tok)
            out.append(tok)
            steps.append(step_logits)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        per_decode = read_counts()
        n_dec = NEW_TOKENS - 1
        for k in path_launches:
            path_launches[k] += per_prefill[k] + per_decode[k]
        finite = bool(torch.isfinite(logits).all()) and all(
            bool(torch.isfinite(s).all()) for s in steps)
        tokens = torch.cat(out, 1)
        emit(phase="path", arch="bert-base", dtype=session.cfg.dtype, weight_cache=wc,
             paged=True, batch=BATCH, prompt=PROMPT, max_len=MAX_LEN,
             new_tokens=NEW_TOKENS, prefill_ms=1e3 * (t1 - t0),
             decode_ms_per_step=1e3 * (t2 - t1) / n_dec,
             tokens_per_s=BATCH * NEW_TOKENS / (t2 - t0),
             peak_mem_bytes=torch.cuda.max_memory_allocated(),
             launches_per_prefill={k: per_prefill[k] for k in path_launches},
             launches_per_decode_step={k: per_decode[k] / n_dec for k in path_launches},
             plain_calls=per_prefill["mpo_linear_plain"] + per_decode["mpo_linear_plain"]
             + per_prefill["flash_decode_attention_plain"]
             + per_decode["flash_decode_attention_plain"],
             logits_finite=finite, tokens_shape=list(tokens.shape),
             compression_ratio=session.report()["compression_ratio"])
        if not finite or tokens.shape != (BATCH, NEW_TOKENS):
            fail(f"weight_cache={wc}: non-finite logits or tokens of shape "
                 f"{tuple(tokens.shape)}")
        if per_decode["flash_decode_attention"] == 0:
            fail(f"weight_cache={wc}: decode never launched the flash kernel")
        if not wc and (per_prefill["mpo_linear_fwd"] == 0 or per_decode["mpo_linear_fwd"] == 0):
            fail("weight_cache=False: prefill or decode never launched the MPO-linear kernel")
        if any(per_prefill[k] or per_decode[k] for k in
               ("mpo_linear_plain", "flash_decode_attention_plain")):
            fail(f"weight_cache={wc}: a plain version ran on the card's path")
        prefill_logits[wc] = logits.float()
    diff = (prefill_logits[True] - prefill_logits[False]).abs().max().item()
    scale = prefill_logits[True].abs().max().item()
    emit(phase="path", prefill_logits_max_abs_diff=diff, scale=scale, tol=PATH_TOL)
    if diff > PATH_TOL * scale:
        fail(f"prefill logits of the two runs differ by {diff} > {PATH_TOL} x {scale}")

    # ---- 4. float32 token parity, then the smoke model card vs CPU ----
    s32 = Session.init("bert-base", smoke=False, seed=SEED, dtype="float32")
    runs = {}
    for name, kw in (("paged_factorized", dict(paged=True, weight_cache=False)),
                     ("paged_cached", dict(paged=True, weight_cache=True)),
                     ("dense_cached", dict(paged=False, weight_cache=True))):
        h = s32.serve(BATCH, MAX_LEN, **kw)
        logits = h.prefill({"tokens": prompts})
        steps = [logits[:, -1]]
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        toks = [tok]
        for _ in range(NEW_TOKENS - 1):
            tok, lg = h.decode(tok)
            toks.append(tok)
            steps.append(lg[:, -1])
        runs[name] = (torch.cat(toks, 1).cpu(), torch.stack(steps, 1).cpu())
    ref_tokens, ref_logits = runs["dense_cached"]
    top2 = ref_logits.topk(2, dim=-1).values
    min_margin = (top2[..., 0] - top2[..., 1]).min().item()
    for name, (toks, _) in runs.items():
        if not torch.equal(toks, ref_tokens):
            row, step = (toks != ref_tokens).nonzero()[0].tolist()
            fail(f"float32 token parity: {name} differs from dense_cached at slot {row} "
                 f"step {step} (top-2 margin there {top2[row, step, 0] - top2[row, step, 1]})")
    emit(phase="parity", dtype="float32", runs=sorted(runs), identical=True,
         tokens=NEW_TOKENS, min_top2_margin=min_margin)

    smoke = {}
    scfg = configs.smoke_config("bert-base")
    scfg = dataclasses.replace(scfg, mpo=dataclasses.replace(scfg.mpo, mode="kernel"))
    for device in ("cuda", "cpu"):
        ss = Session.init(scfg, seed=SEED, device=device)
        small = np.random.default_rng(SEED).integers(0, ss.cfg.vocab_size, (4, 12))
        h = ss.serve(4, 32, paged=True, weight_cache=False)
        logits = h.prefill({"tokens": small}).float().cpu()
        toks = h.generate({"tokens": small}, 8).cpu()
        smoke[device] = (logits, toks)
    sdiff = (smoke["cuda"][0] - smoke["cpu"][0]).abs().max().item()
    sscale = smoke["cpu"][0].abs().max().item()
    emit(phase="parity", smoke="bert-base", mode="kernel", card_vs_cpu_logits_diff=sdiff,
         scale=sscale, tol=SMOKE_TOL, tokens_identical=torch.equal(*[smoke[d][1]
                                                                     for d in smoke]))
    if sdiff > SMOKE_TOL * sscale or not torch.equal(smoke["cuda"][1], smoke["cpu"][1]):
        fail(f"smoke model on the card differs from the CPU: logits {sdiff}, tokens "
             f"{smoke['cuda'][1].tolist()} vs {smoke['cpu'][1].tolist()}")

    # ---- 5. the kernels line ----
    mk = results[("mpo", "attn", 8, "bfloat16")]
    fk = results[("flash", "path", "bfloat16")]
    entry = lambda name, route, source, replaces, rec, case: dict(
        name=name, route=route, source=source, replaces=replaces,
        launches=path_launches[name], max_abs_err=rec["max_abs_err"],
        ms=rec["kernel_ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
        bound_by=rec["bound_by"], library_ms=rec["library_ms"], case=case)
    emit(kernels=[
        entry("mpo_linear_fwd", "cuda", "src/repro_torch/csrc/mpo_linear.cu",
              "src/repro/kernels/mpo_linear.py:216", mk,
              "bert-base attention matrix, M=8 (a decode step), bfloat16"),
        entry("flash_decode_attention", "cuda", "src/repro_torch/csrc/decode_attention.cu",
              "src/repro/kernels/decode_attention.py:166", fk,
              "bert-base geometry KV=12 G=1 Dh=64 ps=16, 8 slots at 144 keys, bfloat16"),
    ])
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
