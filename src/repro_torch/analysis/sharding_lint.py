"""Sharding/placement linter — the port of ``repro.analysis.sharding_lint``,
over the port's rules (``repro_torch.parallel.sharding``).

Works entirely on abstract values: parameter shapes come from the model's
init on the ``meta`` device (``abstract_params``: no weights are drawn, at
any width) and the logical axes from ``core.layers.axes_for``'s same init;
meshes are ``MeshSpec`` stand-ins exposing only ``mesh_dim_names`` /
``shape`` — exactly the surface ``parallel.sharding`` reads — so a CPU
process with no process group lints 4- and 8-rank placements.

Checks, per (config, mesh), as the reference's:

``sharding/coverage``      every logical axis name carried by any leaf must
                           be a key of the rule table (an unknown name is a
                           typo that silently replicates).
``sharding/divisibility``  ``spec_for``'s silent indivisible-dim fallback
                           made loud (warning: the fallback is *designed*
                           behavior, but every instance should be known).
``sharding/head-safety``   the ``head_safe_rules`` invariant: a flattened
                           attention projection whose head count doesn't
                           divide the model-axis product must be replicated
                           — sharding it splits ``head_dim`` across ranks.
``sharding/small-leaf``    1-D leaves smaller than ``d_model`` (norm/scale
                           vectors) must never resolve to a sharded spec —
                           the data-sharded qk-norm-scale bug.

A finding's location spells a leaf's path as the reference's does (dict
keys joined by ``/``), so both packages' findings compare field by field.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.parallel import sharding as S

SHARDING_FILE = "src/repro_torch/parallel/sharding.py"


class MeshSpec:
    """A stand-in for a ``DeviceMesh`` with no process group behind it —
    the two attributes the rule/spec machinery reads (``mesh_dim_names``,
    ``shape``)."""

    def __init__(self, sizes: dict):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(int(v) for v in sizes.values())

    @property
    def sizes(self) -> dict:
        return dict(zip(self.mesh_dim_names, self.shape))

    def describe(self) -> str:
        return ",".join(f"{n}={s}" for n, s in self.sizes.items())

    def __repr__(self):
        return f"MeshSpec({self.describe()})"


# the CLI's default sweep: one device, one 4-rank TP group, and the 8-rank
# data x model mesh (the reference's)
DEFAULT_MESHES = (MeshSpec({"data": 1, "model": 1}),
                  MeshSpec({"data": 1, "model": 4}),
                  MeshSpec({"data": 2, "model": 4}))


def describe(mesh) -> str:
    """``data=2,model=4`` for a ``MeshSpec`` or a ``DeviceMesh``."""
    if hasattr(mesh, "describe"):
        return mesh.describe()
    return ",".join(f"{n}={s}" for n, s in S.mesh_axis_sizes(mesh).items())


@functools.lru_cache(maxsize=64)
def abstract_params(cfg):
    """(meta-tensor tree, axes tree) of ``cfg``'s model: its init on the
    ``meta`` device, nothing drawn or allocated."""
    from repro_torch.core.layers import annotating, split_annotations
    from repro_torch.models.model import family_module
    with torch.device("meta"), annotating():
        tree = family_module(cfg).init(torch.Generator(), cfg)
    return split_annotations(tree)


def production_rules(cfg, mesh) -> dict:
    """The rule table serving and the dry run apply (head-safe)."""
    return S.head_safe_rules(S.make_rules(mesh, sp=cfg.parallelism == "sp"), cfg, mesh)


def leaf_items(shapes, axes, prefix: str = ""):
    """[(path, leaf, axes tuple | None), ...] of nested dicts, the path's
    keys joined by ``/``."""
    if isinstance(shapes, dict):
        out = []
        for k, v in shapes.items():
            out += leaf_items(v, axes[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], shapes, axes)]


def _axis_prod(rules: dict, name: str, sizes: dict) -> int:
    ax = rules.get(name)
    if ax is None:
        return 1
    ax = (ax,) if isinstance(ax, str) else ax
    return math.prod(sizes[a] for a in ax if a in sizes)


def lint_sharding(cfg, mesh, *, rules=None, shapes=None, axes=None) -> list:
    """Findings for one (config, mesh, rule table).

    ``rules`` defaults to the production (head-safe) table — the clean
    path; tests seed the head-splitting violation with the raw
    ``make_rules`` output.  ``shapes`` / ``axes`` default to the abstract
    init's trees; any leaf with a ``shape`` will do (a session's live
    tensors)."""
    if shapes is None or axes is None:
        shapes, axes = abstract_params(cfg)
    if rules is None:
        rules = production_rules(cfg, mesh)
    sizes = S.mesh_axis_sizes(mesh)
    meshstr = describe(mesh)
    findings = []

    def add(check, severity, location, message):
        findings.append(Finding(check=check, severity=severity, file=SHARDING_FILE,
                                location=location, message=message, config=cfg.name,
                                mesh=meshstr))

    # ---- head-safety: the rule table itself must respect head counts ----
    for rule_name, heads, label in (("qkv", cfg.num_heads, "num_heads"),
                                    ("kv_qkv", cfg.num_kv_heads, "num_kv_heads")):
        prod = _axis_prod(rules, rule_name, sizes)
        if prod > 1 and heads % prod != 0:
            add("sharding/head-safety", "error", f"rules[{rule_name!r}]",
                f"{label}={heads} does not divide the model-axis product {prod}: sharding "
                f"the flattened projection splits head_dim across ranks (numerically "
                f"wrong). Apply head_safe_rules / replicate this projection.")

    # ---- per-leaf checks ----
    seen_missing = set()
    for path, sd, ax in leaf_items(shapes, axes):
        if ax is None:
            continue
        shape = tuple(sd.shape)
        for name in ax:
            if name is not None and name not in rules and name not in seen_missing:
                seen_missing.add(name)
                add("sharding/coverage", "error", path,
                    f"logical axis {name!r} is not covered by the rule table — it silently "
                    f"replicates; add a rule (or an explicit None) to make_rules")
        resolved = S.resolve_dims(ax, shape, rules, sizes)
        for dim_idx, ((_, reason), name) in enumerate(zip(resolved, ax)):
            if reason == "indivisible":
                prod = _axis_prod(rules, name, sizes)
                add("sharding/divisibility", "warning", f"{path}[dim {dim_idx}]",
                    f"dim size {shape[dim_idx]} (axis {name!r}) does not divide mesh "
                    f"product {prod}; spec_for falls back to replication for this dim")
        if len(shape) == 1 and shape[0] < cfg.d_model \
                and any(r == "sharded" for _, r in resolved):
            add("sharding/small-leaf", "error", path,
                f"1-D leaf of size {shape[0]} (< d_model={cfg.d_model}) resolves to a "
                f"sharded spec via axis {ax[0]!r} — small norm/scale vectors must stay "
                f"replicated (the data-sharded qk-norm-scale bug)")
    return findings
