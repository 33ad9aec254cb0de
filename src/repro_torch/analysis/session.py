"""Session-facing summary: the cheap detector families over live state —
the port of ``repro.analysis.session``.

``Session.report()["analysis"]`` calls this with the session's parameter
tree and axes (no re-init, no tracing): sharding placement is linted at
the default abstract mesh sweep and the kernel budgets at the session's
current core shapes, so bonds a squeeze truncated are re-checked.  The
trace linter is NOT run here — it costs traces and belongs to
``repro-torch-lint``, not a report call."""

from __future__ import annotations

from repro_torch.analysis.findings import summarize
from repro_torch.analysis.kernel_budget import lint_kernels
from repro_torch.analysis.sharding_lint import (DEFAULT_MESHES, abstract_params,
                                                lint_sharding)


def session_summary(cfg, params=None, axes=None, meshes=DEFAULT_MESHES, *,
                    max_findings: int = 8) -> dict:
    """Findings summary dict (counts by severity/check + the first few
    formatted findings).  ``params`` may be any tree of tensors (their
    shapes are read, never their values)."""
    if params is None or axes is None:
        params, axes = abstract_params(cfg)
    findings = []
    for mesh in meshes:
        findings += lint_sharding(cfg, mesh, shapes=params, axes=axes)
    findings += lint_kernels(cfg, shapes_tree=params)
    out = summarize(findings)
    out["meshes"] = [m.describe() for m in meshes]
    out["findings"] = [f.format() for f in findings[:max_findings]]
    return out
