"""Finding records + baseline suppression for the static analyzer — the
port's copy of ``repro.analysis.findings``.

A ``Finding`` pins a violated invariant to its provenance: the detector
(``check``), the source file where the invariant lives, the config/mesh it
was evaluated against, and the specific location (param path, kernel call,
phase).  Fingerprints hash the *identity* fields only — messages carry
numbers that may drift (byte counts, shapes) without churning baselines.

A fingerprint hashes the same fields as the reference's, so a baseline
written by either package's linter suppresses in the other.

The baseline workflow mirrors every grown-up linter: ``repro-torch-lint
--write-baseline lint.json`` records the current findings' fingerprints;
subsequent runs with ``--baseline lint.json`` fail only on NEW findings.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

SEVERITIES = ("error", "warning", "info")
BASELINE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    check: str              # detector id, e.g. "sharding/head-safety"
    severity: str           # "error" | "warning" | "info"
    file: str               # repo-relative file the invariant lives in
    location: str           # param path / kernel call / phase
    message: str            # human-readable, may carry volatile numbers
    config: str = ""        # arch name ("" = config-independent)
    mesh: str = ""          # e.g. "data=2,model=4" ("" = mesh-independent)

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {self.severity!r}")

    @property
    def fingerprint(self) -> str:
        ident = "|".join((self.check, self.config, self.mesh, self.location))
        return hashlib.sha1(ident.encode()).hexdigest()[:16]

    def format(self) -> str:
        scope = ",".join(s for s in (self.config, self.mesh) if s)
        scope = f" [{scope}]" if scope else ""
        return (f"{self.severity.upper():7s} {self.check}{scope} "
                f"{self.file}: {self.location}: {self.message}")


def summarize(findings) -> dict:
    """Counts by severity and by check — the shape Session.report embeds."""
    by_sev = {s: 0 for s in SEVERITIES}
    by_check: dict[str, int] = {}
    for f in findings:
        by_sev[f.severity] += 1
        by_check[f.check] = by_check.get(f.check, 0) + 1
    return {"errors": by_sev["error"], "warnings": by_sev["warning"],
            "info": by_sev["info"], "by_check": by_check,
            "clean": by_sev["error"] == 0}


def format_findings(findings) -> str:
    order = {s: i for i, s in enumerate(SEVERITIES)}
    ranked = sorted(findings, key=lambda f: (order[f.severity], f.check,
                                             f.config, f.mesh, f.location))
    return "\n".join(f.format() for f in ranked)


def save_baseline(path: str, findings) -> None:
    fps = {f.fingerprint: f"{f.check} {f.location}" for f in findings}
    with open(path, "w") as fh:
        json.dump({"version": BASELINE_VERSION, "fingerprints": fps},
                  fh, indent=1, sort_keys=True)
        fh.write("\n")


def load_baseline(path: str) -> set:
    """Fingerprints to suppress; malformed/mismatched files suppress nothing
    (fail loud — a stale baseline must not hide findings)."""
    try:
        with open(path) as fh:
            raw = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return set()
    if not isinstance(raw, dict) or raw.get("version") != BASELINE_VERSION:
        return set()
    fps = raw.get("fingerprints")
    return set(fps) if isinstance(fps, dict) else set()


def new_findings(findings, baseline: set):
    return [f for f in findings if f.fingerprint not in baseline]
