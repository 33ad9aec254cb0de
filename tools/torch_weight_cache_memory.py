#!/usr/bin/env python3
"""Device memory of the serving weight cache on one NVIDIA GPU, the cache
held in float32 and cast at every use against the cache held in the
activation dtype.

    python3 tools/torch_weight_cache_memory.py [--arch bert-base]

Full-width ``--arch`` in bf16, ``serve(8, 256, paged=True)`` from 8 prompts
of 128 tokens, 32 new tokens, two ways in turns (f32, bf16, bf16, f32):

- ``f32``: every stacked matrix contracted as a list of float32 layers and
  stacked (``mpo.reconstruct_stacked``), kept in float32 and cast to bf16 by
  the engine at every use;
- ``bf16``: ``Model.cache_weights``, each layer contracted on its own into
  one preallocated bf16 tensor.

For each: the cache's bytes, the peak above the allocation before it while
it is built, and the serving run's peak (the prefill and decode steps);
and the greedy tokens and every step's logits, which must be bit for bit
equal between the two.  One JSON line a run, the card's ``nvidia-smi`` name
and power limit first.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def f32_cache(engine, params):
    """The float32 weight cache as it was built before it took a dtype: the
    layers of a stack contracted as a list and stacked."""
    from repro_torch.core import layers, mpo
    if "cores" in params:
        cores = layers.cores_to_list(params["cores"])
        if engine.plan(tuple(tuple(c.shape[-4:]) for c in cores), 1, "decode").mode != "cached":
            return params
        return {"w": mpo.reconstruct_stacked(cores)}
    return {k: f32_cache(engine, v) if isinstance(v, dict) else v for k, v in params.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bert-base")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_weight_cache_memory: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import Session
    from repro_torch.core import lightweight
    from repro_torch.train.steps import make_serve_steps
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    sess = Session.init(args.arch, smoke=False, seed=0)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, sess.cfg.vocab_size, (8, 128)).astype(np.int32), device="cuda")
    prefill, decode, init_serve, _ = make_serve_steps(sess.model, weight_cache=False, paged=True)
    builds = {"f32": lambda p: f32_cache(sess.engine, p), "bf16": sess.model.cache_weights}
    out = {}
    for name in ("f32", "bf16", "bf16", "f32"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            tree = builds[name](sess.params)
            torch.cuda.synchronize()
            build_peak = torch.cuda.max_memory_allocated() - base
            live = {id(t) for t in lightweight.leaves(sess.params)}
            cache_bytes = sum(t.numel() * t.element_size() for t in lightweight.leaves(tree)
                              if id(t) not in live)
            params, cache = init_serve(tree, 8, 256)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            logits = prefill(params, {"tokens": prompts}, cache)[0]
            steps = [logits[:, -1]]
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            toks = [tok]
            for _ in range(31):
                tok, lg, cache = decode(params, tok, cache)
                toks.append(tok)
                steps.append(lg[:, -1])
            torch.cuda.synchronize()
        rec = {"arch": args.arch, "cache": name, "cache_bytes": cache_bytes,
               "build_peak_above_before_bytes": build_peak,
               "serve_allocated_bytes": before, "serve_peak_bytes": torch.cuda.max_memory_allocated()}
        print(json.dumps(rec), flush=True)
        out[name] = (torch.cat(toks, 1).cpu(), torch.stack(steps, 1).float().cpu())
        del tree, params, cache, logits, steps
    same = torch.equal(out["f32"][0], out["bf16"][0]) and torch.equal(out["f32"][1], out["bf16"][1])
    print(json.dumps({"arch": args.arch, "tokens_and_logits_bit_equal": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
