"""``repro-torch-pipeline``: the port's ``Session`` lifecycle and serving
front end from the command line — the port of ``repro.pipeline.cli``.

Runs on the card unless given ``--device cpu``.  The lifecycle command, on
a smoke-scale architecture: init (or the classification subject with
``--cls``), lightweight fine-tune, optional dimension squeezing, a short
greedy generation through the serving path, and the stage report as JSON::

    repro-torch-pipeline --arch qwen3-14b --steps 40 --tokens 8
    repro-torch-pipeline --arch bert-base --cls --squeeze --device cpu
    (or: python -m repro_torch.pipeline.cli ...)

* ``--session-dir DIR`` — restore the session from DIR when a manifest
  exists there (skipping straight to serving + report), else run the
  lifecycle and ``Session.save`` it to DIR at the end.
* ``--ckpt-dir DIR`` — fine-tune checkpoints in DIR, squeeze journal in
  DIR/squeeze; a preempted run re-invoked with the same flags resumes.
* ``--chaos SPEC`` (repeatable) — a deterministic ``FaultPlan``
  (``resilience.faults.FaultPlan.parse``).  An injected preemption exits 3,
  an injected checkpoint crash exits 4 — rerun to resume.

The serving front end::

    repro-torch-pipeline serve-replay --requests 100 --rate 20 --chunk 8 --bucket

replays a seeded open-loop Poisson trace against a ``ServePool`` and prints
the latency/throughput summary as JSON; ``--replicas N`` serves it through
an N-replica ``PoolRouter`` fleet (``--chaos kill-pool:1:40`` crashes a
replica mid-replay: it fails over, is rebuilt and rejoins).

Fleet warm start (the autotuner's verdicts as a shippable artifact)::

    repro-torch-pipeline tune-export PATH                pack this host's verdict cache
    repro-torch-pipeline tune-import PATH [--overwrite]  merge an artifact into it

The report carries the static analysis of the session's trees
(``analysis``); ``--strict-analysis`` exits 1 when it has errors
(``repro-torch-lint`` runs the full sweep).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys


def _device_arg(ap: argparse.ArgumentParser):
    ap.add_argument("--device", default="cuda",
                    help="torch device the session runs on (default: the card; "
                         "'cpu' for a machine without one)")


def _tune_main(argv) -> int:
    """tune-export / tune-import: pack or merge the autotuner's verdict cache."""
    cmd = argv[0]
    ap = argparse.ArgumentParser(
        prog=f"repro-torch-pipeline {cmd}",
        description="Export this host's kernel-autotune verdicts as a "
                    "fleet-shippable artifact, or merge such an artifact "
                    "into the local cache (local verdicts win unless "
                    "--overwrite).")
    ap.add_argument("path", help="artifact path (a JSON verdict pack)")
    if cmd == "tune-import":
        ap.add_argument("--overwrite", action="store_true",
                        help="imported verdicts replace local ones on key collisions")
    args = ap.parse_args(argv[1:])
    from repro_torch.kernels import autotune
    if cmd == "tune-export":
        res = autotune.export_cache(args.path)
        print(f"[tune-export] {res['exported']} verdicts -> {res['path']}")
    else:
        res = autotune.import_cache(args.path, overwrite=args.overwrite)
        print(f"[tune-import] {res['imported']} imported, {res['skipped']} skipped "
              f"(local wins) -> {res['path']} ({res['total']} total)")
    return 0


def _replay_main(argv) -> int:
    """serve-replay: open-loop Poisson traffic against a ServePool."""
    from repro_torch import configs
    ap = argparse.ArgumentParser(
        prog="repro-torch-pipeline serve-replay",
        description="Replay a seeded open-loop (Poisson-arrival) request "
                    "trace against a multi-tenant ServePool and print the "
                    "latency/throughput summary as JSON.  The trace is "
                    "deterministic in --seed; --virtual-clock makes the "
                    "whole replay deterministic.")
    ap.add_argument("--arch", default="qwen3-14b", choices=list(configs.ARCHS))
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--rate", type=float, default=20.0,
                    help="offered load, requests/second (Poisson)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(4, 24),
                    metavar=("LO", "HI"))
    ap.add_argument("--max-new", type=int, nargs=2, default=(1, 16),
                    metavar=("LO", "HI"))
    ap.add_argument("--chunk", type=int, default=None,
                    help="chunked admission prefill size (tokens); omit "
                         "for whole-prompt admission")
    ap.add_argument("--bucket", action="store_true",
                    help="pad prompts to power-of-two length buckets")
    ap.add_argument("--paged", action="store_true", help="paged pool KV cache")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--virtual-clock", action="store_true",
                    help="deterministic virtual time (fixed cost per pool "
                         "step) instead of wall clock")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a PoolRouter fleet of N replica pools")
    ap.add_argument("--shed-depth", type=int, default=None,
                    help="fleet load-shedding: fail fast (status 'shed') "
                         "past this many outstanding requests")
    ap.add_argument("--session-dir", default=None,
                    help="save the session here and rebuild tripped "
                         "replicas from it (default: from the live session)")
    ap.add_argument("--chaos", action="append", default=[], metavar="SPEC",
                    help="deterministic fault injection (repeatable), e.g. "
                         "kill-pool:IDX:STEP, trip-pool:IDX, shed-storm:K, "
                         "nan-decode:STEP[:SLOT]; grammar in "
                         "resilience.faults.FaultPlan.parse")
    _device_arg(ap)
    args = ap.parse_args(argv[1:])

    from repro_torch.pipeline import traffic
    from repro_torch.pipeline.clock import VirtualClock, WallClock
    from repro_torch.pipeline.session import Session
    from repro_torch.resilience import faults
    session = Session.init(args.arch, device=args.device)
    clock = VirtualClock() if args.virtual_clock else WallClock()
    pool_kw = dict(paged=args.paged, page_size=args.page_size,
                   prefill_chunk=args.chunk, bucket_prompts=args.bucket)
    if args.replicas > 1:
        pool = session.serve_fleet(
            args.replicas, args.slots, args.max_len, clock=clock,
            session_dir=args.session_dir,
            router={"shed_queue_depth": args.shed_depth}, **pool_kw)
    else:
        pool = session.serve_pool(args.slots, args.max_len, clock=clock, **pool_kw)
    trace = traffic.make_trace(
        args.requests, args.rate, seed=args.seed,
        prompt_len=tuple(args.prompt_len), max_new=tuple(args.max_new),
        vocab_size=min(session.cfg.vocab_size, 1000))
    scope = (faults.fault_scope(faults.FaultPlan.parse(args.chaos))
             if args.chaos else contextlib.nullcontext())
    with scope:
        report = traffic.replay(pool, trace, clock=clock)
    stats = pool.stats()
    out = {"summary": report.summary, "device": str(session.device)}
    if args.replicas > 1:
        out["router"] = {
            "replicas": [{"idx": r["idx"], "state": r["state"],
                          "trips": r["trips"], "rebuilds": r["rebuilds"]}
                         for r in stats["replicas"]],
            "retries": stats["retries"], "shed": stats["shed"],
            "trips": stats["trips"], "rebuilds": stats["rebuilds"],
            "fail_reasons": stats["fail_reasons"],
        }
    else:
        out.update(prefill_traces=stats["prefill_traces"],
                   prefill_toks_s=stats["prefill_toks_s"],
                   decode_toks_s=stats["decode_toks_s"],
                   occupancy=round(stats["occupancy"], 4))
    print(json.dumps(out, indent=2))
    return 0


def sample_batch(cfg, batch: int, prompt_len: int, seed: int = 0) -> dict:
    """The serving sample's prefill batch, with the shapes of the
    reference's ``make_batch`` at a ``prefill`` of ``prompt_len`` (numpy
    draws): tokens in ``[0, min(vocab, 1000))``, and the family's frontend
    input (``data.pipeline.frontend_input``): a ``vlm`` prompt's
    ``frontend_len`` positions are patches ahead of its text, an ``encdec``
    batch adds the encoder's frames."""
    import numpy as np

    from repro_torch.data.pipeline import frontend_input
    rng = np.random.default_rng(seed)
    text = prompt_len - (cfg.frontend_len if cfg.family == "vlm" else 0)
    if text < 1:
        raise ValueError(f"--prompt-len {prompt_len} leaves no text after the "
                         f"{cfg.frontend_len} patches")
    out = {"tokens": rng.integers(0, min(cfg.vocab_size, 1000), (batch, text)).astype(np.int32)}
    frontend = frontend_input(cfg)
    if frontend is not None:
        out[frontend[0]] = rng.normal(0, 1, (batch, cfg.frontend_len, frontend[1])).astype(
            np.float32)
    return out


def _run(args) -> int:
    from repro_torch.pipeline.session import Session

    session = None
    if args.session_dir and os.path.exists(os.path.join(args.session_dir, "session.json")):
        session = Session.restore(args.session_dir, device=args.device)
        print(f"[repro-torch-pipeline] restored session from {args.session_dir} "
              f"(stage={session.stage}, weights_version={session.weights_version})")
    if session is None:
        overrides = {"num_classes": 2} if args.cls else {}
        session = Session.init(args.arch, device=args.device, **overrides)
        session.finetune(mode=args.mode, steps=args.steps, lr=args.lr,
                         ckpt_dir=args.ckpt_dir, verbose=args.verbose)
        if args.squeeze:
            jdir = os.path.join(args.ckpt_dir, "squeeze") if args.ckpt_dir else None
            session.squeeze(delta=args.delta, max_iters=args.max_iters,
                            ckpt_dir=jdir, verbose=args.verbose)
        if args.session_dir:
            session.save(args.session_dir)
            print(f"[repro-torch-pipeline] session saved to {args.session_dir}")
    if args.tokens and session.task == "lm":
        handle = session.serve(args.batch, args.prompt_len + args.tokens + 1)
        batch = sample_batch(session.cfg, args.batch, args.prompt_len)
        ids = handle.generate(batch, args.tokens)
        print(f"[repro-torch-pipeline] sample ids: {ids[0].tolist()}")
    report = session.report()
    print(json.dumps(report, indent=2, default=float))
    if args.strict_analysis and report.get("analysis", {}).get("errors"):
        return 1
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in ("tune-export", "tune-import"):
        return _tune_main(argv)
    if argv and argv[0] == "serve-replay":
        return _replay_main(argv)

    from repro_torch import configs

    ap = argparse.ArgumentParser(prog="repro-torch-pipeline", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen3-14b", choices=list(configs.ARCHS))
    ap.add_argument("--cls", action="store_true",
                    help="classification task (adds a 2-class head; the "
                         "paper's GLUE-analog setting)")
    ap.add_argument("--mode", default="lfa", choices=["lfa", "full", "central_only"])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--squeeze", action="store_true",
                    help="run dimension squeezing (Algorithm 2) after the fine-tune")
    ap.add_argument("--delta", type=float, default=0.08)
    ap.add_argument("--max-iters", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=8,
                    help="tokens to decode through the serving path "
                         "(LM tasks only; 0 disables)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="fine-tune checkpoints here; the squeeze journal "
                         "goes in <dir>/squeeze — rerun with the same "
                         "flags to resume a preempted run")
    ap.add_argument("--session-dir", default=None,
                    help="restore the session from here if a manifest "
                         "exists, else save the finished session here")
    ap.add_argument("--chaos", action="append", default=[], metavar="SPEC",
                    help="inject a deterministic fault (repeatable); grammar in "
                         "resilience.faults.FaultPlan.parse")
    ap.add_argument("--strict-analysis", action="store_true",
                    help="exit nonzero if the report's static-analysis summary contains "
                         "errors (repro-torch-lint runs the full sweep; this gates just "
                         "this session's trees)")
    ap.add_argument("--verbose", action="store_true")
    _device_arg(ap)
    args = ap.parse_args(argv)

    from repro_torch.resilience import faults
    scope = (faults.fault_scope(faults.FaultPlan.parse(args.chaos))
             if args.chaos else contextlib.nullcontext())
    try:
        with scope:
            return _run(args)
    except faults.Preemption as e:
        print(f"[repro-torch-pipeline] preempted: {e} — rerun with the same "
              "--ckpt-dir/--session-dir to resume", file=sys.stderr)
        return 3
    except faults.CrashPoint as e:
        print(f"[repro-torch-pipeline] crashed: {e} — the previous checkpoint "
              "is intact; rerun to resume", file=sys.stderr)
        return 4


if __name__ == "__main__":
    sys.exit(main())
