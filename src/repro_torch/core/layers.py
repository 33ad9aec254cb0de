"""MPO-parameterized layers with logical sharding axes — the port of
``repro.core.layers``.

Every ``init_*`` returns a nested dict of tensors whose key paths are the
reference's (a factorized matrix is ``{"cores": {"c0": ..., "central": ...}}``,
a dense one ``{"w": ...}``).  The central MPO core lives under
``"central"``, the auxiliary cores under ``"c{k}"``: lightweight
fine-tuning keys on that naming.

Inside ``annotating()`` every leaf comes back as ``Annot(value, axes)``
instead: ``axes`` is a tuple of logical axis names (or ``None``) per dim,
the reference's, which ``repro_torch.parallel.sharding`` maps onto a
``DeviceMesh``; ``split_annotations`` separates the tree into (params,
axes).  ``axes_for(cfg)`` builds a model's axes tree on the ``meta``
device, so it costs no weights at any width.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Sequence

import torch

from repro_torch.core import mpo

# --------------------------------------------------------------------------
# logical-axis annotations
# --------------------------------------------------------------------------


class Annot:
    """A leaf and its logical-axis names, one per dim (the reference's
    ``Annot``): what the ``init_*`` functions return inside
    ``annotating()``."""

    __slots__ = ("value", "axes")

    def __init__(self, value, axes: tuple):
        self.value = value
        self.axes = tuple(axes)

    def __repr__(self):
        return f"Annot({tuple(getattr(self.value, 'shape', ()))}, {self.axes})"


_ANNOTATE = False


@contextlib.contextmanager
def annotating():
    """Within the block the ``init_*`` functions return ``Annot`` leaves."""
    global _ANNOTATE
    prev, _ANNOTATE = _ANNOTATE, True
    try:
        yield
    finally:
        _ANNOTATE = prev


def annot(value, axes: tuple):
    """``Annot(value, axes)`` inside ``annotating()``, else ``value``."""
    return Annot(value, axes) if _ANNOTATE else value


def split_annotations(tree):
    """(params, axes) from an ``Annot``-leaf tree of nested dicts."""
    if isinstance(tree, dict):
        pairs = {k: split_annotations(v) for k, v in tree.items()}
        return ({k: p for k, (p, _) in pairs.items()},
                {k: a for k, (_, a) in pairs.items()})
    return tree.value, tree.axes


@functools.lru_cache(maxsize=None)
def axes_for(cfg) -> dict:
    """The logical-axis tree of ``cfg``'s model (the reference's
    ``model.init_params(key)[1]``), built on the ``meta`` device: no
    weights are drawn, at any width."""
    from repro_torch.models.model import family_module   # lazy: import cycle
    with torch.device("meta"), annotating():
        tree = family_module(cfg).init(torch.Generator(), cfg)
    return split_annotations(tree)[1]


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MPOConfig:
    """How (and whether) matrices are MPO-factorized.

    Per-kind bond dims cap the truncation (``None`` = exact); ``mode``
    forces an execution mode or leaves the choice to the engine's
    phase-aware planning (``"auto"``, the default).  Example::

        cfg = MPOConfig(n=5, bond_ffn=64, bond_attn=64, bond_embed=32)
        lin = init_linear(gen, 1024, 4096, cfg=cfg, kind="ffn")
        MPOConfig(enabled=False)     # == DENSE: no factorization at all
    """

    enabled: bool = True
    n: int = 5
    bond_embed: int | None = 64
    bond_attn: int | None = 128
    bond_ffn: int | None = 128
    # execution mode: auto | factorized | reconstruct | kernel | cached
    mode: str = "auto"
    # divisibility required of core-0 factors on model-sharded dims
    shard_multiple: int = 1
    # which core's legs carry the tensor-parallel sharding: "first" | "central"
    shard_leg: str = "first"
    # stop gradients into the central cores (the engine detaches them)
    freeze_central_grads: bool = False

    def bond_for(self, kind: str) -> int | None:
        return {"embed": self.bond_embed, "attn": self.bond_attn,
                "ffn": self.bond_ffn}[kind]


DENSE = MPOConfig(enabled=False)


def _safe_multiple(dim: int, multiple: int) -> int:
    return multiple if (multiple > 1 and dim % multiple == 0) else 1


def make_spec(cfg: MPOConfig, in_dim: int, out_dim: int, kind: str,
              in_sharded: bool, out_sharded: bool) -> mpo.MPOSpec:
    idx = 0 if cfg.shard_leg == "first" else cfg.n // 2
    im = _safe_multiple(in_dim, cfg.shard_multiple) if in_sharded else 1
    om = _safe_multiple(out_dim, cfg.shard_multiple) if out_sharded else 1
    return mpo.MPOSpec(
        in_factors=mpo.auto_factorize(in_dim, cfg.n, im, idx),
        out_factors=mpo.auto_factorize(out_dim, cfg.n, om, idx),
        bond_dim=cfg.bond_for(kind),
    )


# --------------------------------------------------------------------------
# core naming / assembly
# --------------------------------------------------------------------------


def core_names(n: int) -> list[str]:
    mid = n // 2
    return ["central" if k == mid else f"c{k}" for k in range(n)]


def cores_to_list(cores_dict: dict) -> list[torch.Tensor]:
    return [cores_dict[name] for name in core_names(len(cores_dict))]


def cores_from_list(cores: Sequence[torch.Tensor]) -> dict:
    return dict(zip(core_names(len(cores)), cores))


def _core_axes(spec: mpo.MPOSpec, in_axis, out_axis,
               shard_leg: str = "first") -> list[tuple]:
    """Logical axes per core.  "first" (default): the tensor-parallel
    sharding on core 0's i/j legs — row-major factor order makes those W's
    outermost digits, so each shard is a contiguous block of W and a valid
    MPO of it; the central core (the parameter mass) is FSDP-sharded along
    its leading bond.  "central": the paper-naive layout (shard the central
    core's legs)."""
    tp_core = 0 if shard_leg == "first" else spec.central_index
    axes = []
    for k in range(spec.n):
        if k == tp_core:
            axes.append((None, in_axis, out_axis, None))
        elif k == spec.central_index:
            axes.append(("bond", None, None, None))
        else:
            axes.append((None, None, None, None))
    return axes


# --------------------------------------------------------------------------
# linear / embedding
# --------------------------------------------------------------------------


def init_linear(gen: torch.Generator, in_dim: int, out_dim: int, *,
                cfg: MPOConfig, kind: str = "ffn", in_axis=None, out_axis=None,
                sharded_in: bool = False, sharded_out: bool = False,
                scale: float | None = None, dtype=torch.float32) -> dict:
    """A (possibly MPO-factorized) ``in_dim -> out_dim`` matrix, drawn from
    ``gen`` on its device.  ``in_axis`` / ``out_axis`` name W's dims; a
    factorized matrix carries them on core 0's legs when ``sharded_in`` /
    ``sharded_out``."""
    if not cfg.enabled:
        std = scale if scale is not None else in_dim ** -0.5
        return {"w": annot(std * mpo.randn((in_dim, out_dim), gen, dtype),
                           (in_axis, out_axis))}
    spec = make_spec(cfg, in_dim, out_dim, kind, sharded_in, sharded_out)
    cores = mpo.init_cores(gen, spec, scale=scale, dtype=dtype)
    ax = _core_axes(spec, in_axis if sharded_in else None,
                    out_axis if sharded_out else None, shard_leg=cfg.shard_leg)
    return {"cores": {name: annot(c, a) for name, c, a in
                      zip(core_names(spec.n), cores, ax)}}


def init_embedding(gen: torch.Generator, vocab: int, dim: int, *,
                   cfg: MPOConfig, vocab_axis="vocab", dim_axis=None,
                   dtype=torch.float32) -> dict:
    # a dense (mpo disabled) embedding keeps vocab sharding; a factorized
    # one is small enough to replicate — the choice changes the
    # factorization, so it is kept
    return init_linear(gen, vocab, dim, cfg=cfg, kind="embed",
                       in_axis=vocab_axis, out_axis=dim_axis,
                       sharded_in=not cfg.enabled, sharded_out=False,
                       scale=0.02, dtype=dtype)


# ---- execution: thin wrappers over the engine ----


def apply_linear(params: dict, x: torch.Tensor, *, cfg: MPOConfig,
                 transpose: bool = False, phase: str = "train") -> torch.Tensor:
    """y = x @ W (or x @ W^T) through the engine's planned execution mode."""
    from repro_torch.core.engine import engine_for  # lazy: import cycle
    return engine_for(cfg).linear(params, x, transpose=transpose, phase=phase)


def apply_embedding(params: dict, ids: torch.Tensor, *, cfg: MPOConfig,
                    dtype=None, phase: str = "train") -> torch.Tensor:
    from repro_torch.core.engine import engine_for  # lazy: import cycle
    return engine_for(cfg).embedding(params, ids, dtype=dtype, phase=phase)


def apply_logits(params: dict, h: torch.Tensor, *, cfg: MPOConfig,
                 phase: str = "train") -> torch.Tensor:
    """Tied-embedding output head: h @ E^T."""
    from repro_torch.core.engine import engine_for  # lazy: import cycle
    return engine_for(cfg).logits(params, h, phase=phase)
