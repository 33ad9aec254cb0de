"""``repro-torch-lint`` — sweep every config through the static analyzer
(the port of ``repro.analysis.cli``'s ``repro-lint``)::

    repro-torch-lint                      # every config, 1/4/8-rank meshes
    repro-torch-lint --configs qwen3-14b --families sharding,kernel
    repro-torch-lint --write-baseline lint_baseline.json
    repro-torch-lint --baseline lint_baseline.json    # fail only on NEW findings
    repro-torch-lint --ptxas              # on the card, after a build: registers
    (or: python -m repro_torch.analysis.cli ...)

Exit code 1 iff any finding at/above ``--fail-on`` (default: error) is not
suppressed by the baseline file.  ``--ptxas`` (in place of the reference's
``--hlo``) adds the compiler's register and spill report of every library
already built (``kernel_budget.lint_registers``; it starts no build), and
``--smem-budget`` (in place of ``--vmem-budget``) sets the shared memory a
block may use.  The autotuner's verdict cache is surfaced by measurement
substrate (``autotune.substrate``: the card and its compute capability, or
the CPU, with torch's and CUDA's versions) as info findings, so a CPU
verdict is never mistaken for the card's.  Runs on the CPU: fake tensors,
the ``meta`` device and abstract meshes; no card and no process group."""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis import findings as F
from repro_torch.analysis.kernel_budget import SMEM_LIMIT, lint_kernels, lint_registers
from repro_torch.analysis.sharding_lint import MeshSpec, lint_sharding
from repro_torch.analysis.trace_lint import lint_traces

DEFAULT_MESH_ARG = "1x1,1x4,2x4"
AUTOTUNE_FILE = "src/repro_torch/kernels/autotune.py"


def parse_meshes(arg: str) -> list:
    out = []
    for part in arg.split(","):
        data, model = part.lower().split("x")
        out.append(MeshSpec({"data": int(data), "model": int(model)}))
    return out


def autotune_findings(path: str | None = None) -> list:
    """Info findings for every measurement substrate in the autotuner's
    verdict cache: CPU verdicts and verdicts under another torch or CUDA
    version are marked as such."""
    import torch

    from repro_torch.kernels import autotune
    entries = autotune._read_cache(path or autotune.cache_path())
    groups: dict[str, int] = {}
    for key in entries:
        sub = key.split("|shapes=", 1)[0]
        groups[sub] = groups.get(sub, 0) + 1
    out = []
    for sub, count in sorted(groups.items()):
        fields = dict(f.split("=", 1) for f in sub.split("|") if "=" in f)
        tags = []
        if fields.get("device", "?") == "cpu" or "cc" not in fields:
            tags.append("CPU-measured — bring-up only, rankings do not transfer to the card")
        if (fields.get("torch"), fields.get("cuda")) != (torch.__version__,
                                                         str(torch.version.cuda)):
            tags.append(f"measured under torch {fields.get('torch')} / CUDA "
                        f"{fields.get('cuda')}, current is {torch.__version__} / CUDA "
                        f"{torch.version.cuda} — will not answer lookups")
        msg = f"{count} cached verdict(s) measured on {sub}"
        if tags:
            msg += " [" + "; ".join(tags) + "]"
        out.append(F.Finding(check="autotune/substrate", severity="info", file=AUTOTUNE_FILE,
                             location=sub, message=msg))
    return out


def run_lint(archs, meshes, families, *, ptxas: bool = False, smem_budget: int = SMEM_LIMIT,
             progress=None) -> list:
    from repro_torch import configs
    findings = []
    for arch in archs:
        cfg = configs.get_config(arch)
        if progress:
            progress(f"linting {arch} ({cfg.family})")
        if "sharding" in families:
            for mesh in meshes:
                findings += lint_sharding(cfg, mesh)
        if "kernel" in families:
            findings += lint_kernels(cfg, budget=smem_budget)
        if "trace" in families:
            findings += lint_traces(cfg)
    if ptxas:
        findings += lint_registers()
    findings += autotune_findings()
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch-lint",
        description="static correctness analyzer: sharding placement, step hazards, "
                    "Hopper kernel budgets")
    ap.add_argument("--configs", default=None,
                    help="comma-separated arch names (default: every config)")
    ap.add_argument("--meshes", default=DEFAULT_MESH_ARG,
                    help=f"comma-separated DATAxMODEL mesh shapes (default: {DEFAULT_MESH_ARG})")
    ap.add_argument("--families", default="sharding,kernel,trace",
                    help="detector families to run")
    ap.add_argument("--ptxas", action="store_true",
                    help="also read the compiler's register and spill report of every "
                         "built kernel library (on the card, after a build)")
    ap.add_argument("--smem-budget", type=int, default=SMEM_LIMIT,
                    help="dynamic shared memory a block may use, bytes")
    ap.add_argument("--baseline", default=None,
                    help="suppression file: fail only on findings not in it")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="record current findings as the baseline and exit 0")
    ap.add_argument("--fail-on", choices=["error", "warning"], default="error")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch import configs
    archs = args.configs.split(",") if args.configs else sorted(configs.ARCHS)
    meshes = parse_meshes(args.meshes)
    families = set(args.families.split(","))
    progress = None if (args.quiet or args.as_json) else \
        (lambda msg: print(f"# {msg}", file=sys.stderr))

    findings = run_lint(archs, meshes, families, ptxas=args.ptxas,
                        smem_budget=args.smem_budget, progress=progress)

    if args.write_baseline:
        F.save_baseline(args.write_baseline, findings)
        print(f"# wrote {len(findings)} fingerprint(s) to {args.write_baseline}")
        return 0

    baseline = F.load_baseline(args.baseline) if args.baseline else set()
    fresh = F.new_findings(findings, baseline)
    summary = F.summarize(findings)
    summary["suppressed"] = len(findings) - len(fresh)

    if args.as_json:
        payload = {"summary": summary,
                   "findings": [vars(f) | {"fingerprint": f.fingerprint, "new": f in fresh}
                                for f in findings]}
        print(json.dumps(payload, indent=1, sort_keys=True))
    else:
        if findings:
            print(F.format_findings(findings))
        print(f"# repro-torch-lint: {summary['errors']} error(s), {summary['warnings']} "
              f"warning(s), {summary['info']} info across {len(archs)} config(s) x "
              f"{len(meshes)} mesh(es)"
              + (f"; {summary['suppressed']} baseline-suppressed" if baseline else ""))

    gate = ("error",) if args.fail_on == "error" else ("error", "warning")
    return 1 if any(f.severity in gate for f in fresh) else 0


if __name__ == "__main__":
    sys.exit(main())
