"""Dense-checkpoint -> MPO conversion — the port of ``repro.core.convert``.

MPOP compresses a *pretrained* model: every weight matrix of a dense
checkpoint is MPO-decomposed (Algorithm 1) into central + auxiliary tensors,
then the model is lightweight-fine-tuned.  ``convert_dense_to_mpo`` walks a
dense param tree and an MPO model's tree (the template), decomposing each
``w`` into the template's core layout (bond-truncated per the config);
scalars, norms and biases pass through, and stacked ``(L, in, out)`` layers
are decomposed as one batch on their device.  A MoE layer's ``(L, E, in,
out)`` experts are refused, as the reference refuses them.

At full rank the converted model is numerically the dense one (Eq. 1); with
truncation, Eq. 4 bounds each matrix's error.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import mpo


def _decompose_to_shapes(w: torch.Tensor, core_shapes) -> list[torch.Tensor]:
    """Decompose ``w`` (``(..., I, J)``) into cores of ``core_shapes`` (the
    trailing ``(d0, i, j, d1)`` of each core) exactly."""
    in_factors = tuple(s[1] for s in core_shapes)
    out_factors = tuple(s[2] for s in core_shapes)
    bonds = [s[-1] for s in core_shapes[:-1]]
    spec = mpo.MPOSpec(in_factors, out_factors, bond_dim=max(bonds) if bonds else None)
    cores, _ = mpo.decompose(w, spec)
    # decompose() may give smaller canonical bonds than the template allows
    # on very low-rank inputs: pad with zeros so the converted tree has the
    # template's shapes
    out = []
    for c, shape in zip(cores, core_shapes):
        pad = [t - s for s, t in zip(c.shape[-4:], shape)]
        if min(pad) < 0:
            raise ValueError(f"core {tuple(c.shape[-4:])} does not fit the template's {shape}")
        out.append(F.pad(c, [x for p in reversed(pad) for x in (0, p)]) if any(pad) else c)
    return out


def _core_order(cores_dict: dict):
    n = len(cores_dict)
    order = {("central" if k == n // 2 else f"c{k}"): k for k in range(n)}
    return lambda name: order[name]


# Algorithm 1 over stacks of more than one leading dim is refused, as the
# reference refuses it
EXPERT_STACKS = ("Algorithm 1 over a MoE layer's (L, E) expert stacks is not ported: the "
                 "reference's convert_dense_to_mpo takes only (L, I, J) stacks "
                 "(repro/core/convert.py:56) and fails on (L, E, I, J) ones (ROADMAP.md, "
                 "Queue 3 I)")


def convert_dense_to_mpo(dense_params: dict, template: dict) -> dict:
    """Map a dense param tree onto an MPO model's structure.

    ``dense_params``: the tree of the same architecture built with
    ``MPOConfig(enabled=False)``, tensors on the device to convert on.
    ``template``: the MPO model's tree (``Model.tree()``); its core shapes
    give each matrix's factorization and bonds, and its cores' dtypes the
    result's.  Non-matrix leaves come from the dense tree; a key the dense
    tree lacks keeps the template's leaf, as the reference does.  A matrix
    stacked on more than one leading dim (a MoE layer's experts) raises
    ``NotImplementedError``, as the reference fails there."""

    def walk(dense, tmpl):
        if isinstance(tmpl, dict) and "cores" in tmpl and "w" in dense:
            w = dense["w"]
            names = sorted(tmpl["cores"], key=_core_order(tmpl["cores"]))
            cts = [tmpl["cores"][n] for n in names]
            if cts[0].dim() > 5:
                raise NotImplementedError(EXPERT_STACKS)
            if tuple(w.shape[:-2]) != tuple(cts[0].shape[:-4]):
                raise ValueError(f"dense matrix {tuple(w.shape)} does not stack as the "
                                 f"template's cores {tuple(cts[0].shape)}")
            cores = _decompose_to_shapes(w, [tuple(c.shape[-4:]) for c in cts])
            return {"cores": {n: c.to(t.dtype) for n, c, t in zip(names, cores, cts)}}
        if isinstance(tmpl, dict):
            return {k: walk(dense[k], v) if k in dense else v for k, v in tmpl.items()}
        return dense

    return walk(dense_params, template)


def conversion_error(dense_params: dict, mpo_params: dict) -> dict:
    """Per-matrix relative Frobenius reconstruction error of a conversion,
    ``{"layers/attn/wq": err, ...}``; a stacked matrix counts its layers
    together, as the reference does."""
    errs = {}

    def walk(dense, conv, path=()):
        if isinstance(conv, dict) and "cores" in conv and "w" in dense:
            names = sorted(conv["cores"], key=_core_order(conv["cores"]))
            rec = mpo.reconstruct_stacked([conv["cores"][n].float() for n in names])
            w = dense["w"].float()
            errs["/".join(map(str, path))] = float(
                torch.linalg.norm(rec - w) / (torch.linalg.norm(w) + 1e-12))
            return
        if isinstance(conv, dict):
            for k in conv:
                if k in dense:
                    walk(dense[k], conv[k], path + (k,))

    walk(dense_params, mpo_params)
    return errs
