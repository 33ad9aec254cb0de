"""Static correctness analysis — the port of ``repro.analysis``: prove
placement, step and kernel invariants before anything runs on a card.

Three detector families, all runnable on a CPU with no card and no
process group:

``sharding_lint``   rule coverage, divisibility fallbacks made loud, the
                    ``head_safe_rules`` invariant and the small-leaf
                    placement rule over ``parallel.sharding``'s rules, at
                    abstract mesh shapes (``MeshSpec``), on parameter
                    shapes from the ``meta`` device.
``trace_lint``      prefill, decode and the train loss run once on fake
                    tensors: cache drift, host syncs and cross-device
                    copies, prefill/decode logits dtype drift, the decode
                    step's op histogram.
``kernel_budget``   each Hopper kernel's shared memory (from the plans that
                    mirror the CUDA sources) against the 227 KB a block
                    may use, the tile constants against the sources, flash
                    decode's page reads at the corner cases, and on the
                    card the compiler's register and spill report.

The ``repro-torch-lint`` console script (``analysis.cli``) sweeps every
config at 1/4/8-rank mesh shapes and exits nonzero on findings a
``--baseline`` file does not suppress; ``Session.report()["analysis"]``
surfaces the sharding and kernel summary of a live session.
"""

from repro_torch.analysis.findings import (Finding, format_findings, load_baseline,
                                           new_findings, save_baseline, summarize)
from repro_torch.analysis.kernel_budget import (SMEM_LIMIT, lint_decode_attention_call,
                                                lint_kernels, lint_mpo_call, lint_registers)
from repro_torch.analysis.session import session_summary
from repro_torch.analysis.sharding_lint import DEFAULT_MESHES, MeshSpec, lint_sharding
from repro_torch.analysis.trace_lint import lint_traces

__all__ = [
    "Finding", "format_findings", "summarize",
    "load_baseline", "save_baseline", "new_findings",
    "MeshSpec", "DEFAULT_MESHES", "lint_sharding",
    "lint_traces",
    "SMEM_LIMIT", "lint_kernels", "lint_mpo_call", "lint_decode_attention_call",
    "lint_registers",
    "session_summary",
]
