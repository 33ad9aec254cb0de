"""Mixture-of-Experts FFN (top-k routing, capacity-based dense dispatch) —
the port of ``repro.models.moe``.

Experts are stacked on a leading expert dim: every expert matrix is an MPO
matrix whose cores gain that dim, ``(E, d0, i, j, d1)``.  The reference runs
the experts through ``jax.vmap`` of ``nn.apply_mlp``; here the stacked tree
goes straight through ``nn.apply_mlp`` with ``xe`` of shape ``(E, N, D)``,
and ``MPOEngine.linear`` plans each expert matrix as the vmap shows it to the
reference's engine (per expert, ``N`` tokens) and runs all experts in one
call: on the card one launch of the MPO-linear forward a matrix.
Dispatch and combine are dense one-hot einsums, as the reference's.

On a mesh (``parallel.spmd``) an expert stack spread over ``model`` along
its expert dim (the rules' ``"expert": ("model",)``, kept under sp) runs
expert-parallel: the router's table is gathered whole, so every rank
routes every token exactly as one device does; the capacity, ``dispatch``
and ``combine`` are computed whole, each rank takes its experts' slice of
them, runs its E/m experts and the partial outputs are summed over
``model``.  Where E does not divide ``model`` the stack is tensor-parallel
over its core 0 (the rules' ``ffn``) and the layer runs as on one device.
"""

from __future__ import annotations

import torch

from repro_torch.core import layers as L
from repro_torch.core.layers import MPOConfig
from repro_torch.core.mpo import randn
from repro_torch.models import nn
from repro_torch.parallel import spmd


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, num_experts: int,
             act: str, mpo: MPOConfig) -> dict:
    """``{"router": {"w": (D, E) f32}, "experts": init_mlp stacked on E}``
    under the reference's key paths."""
    router = {"w": L.annot((d_model ** -0.5) * randn((d_model, num_experts), gen),
                           ("embed", "expert"))}
    experts = nn.stack_layers(lambda g: nn.init_mlp(g, d_model, d_ff, act, mpo), gen,
                              num_experts, axis="expert")
    return {"router": router, "experts": experts}


def stable_top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last dim: the ``k`` largest values, ties
    broken towards the lower index (a stable descending sort), so a row of
    equal logits (an idle pool slot's zeros) routes as the reference does."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(params: dict, x: torch.Tensor, *, act: str, mpo: MPOConfig, top_k: int,
              capacity_factor: float = 1.25, phase: str = "train"):
    """x: (B, S, D) -> ((B, S, D), the Switch-style load-balance loss).

    Each expert takes at most ``cap = max(4, int(capacity_factor * S * k /
    E))`` tokens of a sequence, claimed in order along S and, for k > 1,
    after the tokens of the earlier choices; a token past its expert's
    capacity is dropped from that expert (its share of y is zero)."""
    b, s, d = x.shape
    e = params["router"]["w"].shape[-1]
    cap = max(4, int(capacity_factor * s * top_k / e))

    # router math in f32, over the whole table on every rank of a mesh
    logits = x.float() @ _whole_table(params["router"]["w"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = stable_top_k(probs, top_k)              # (B, S, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # capacity-aware dispatch, the choices in order
    combine = torch.zeros((b, s, e, cap), dtype=torch.float32, device=x.device)
    counts = torch.zeros((b, e), dtype=torch.int64, device=x.device)
    for k in range(top_k):
        mask_k = torch.nn.functional.one_hot(gate_idx[..., k], e)       # (B, S, E)
        pos = torch.cumsum(mask_k, dim=1) - 1 + counts[:, None, :]
        ok = (pos < cap) & (mask_k > 0)
        pos_oh = torch.nn.functional.one_hot(pos.clamp(0, cap - 1), cap).float()
        combine = combine + gate_vals[..., k, None, None] * pos_oh * ok[..., None]
        counts = counts + (mask_k * ok).sum(1)
    combine = combine.to(x.dtype)
    mesh = _expert_mesh(params["experts"])
    xin = x
    if mesh is not None:
        # the rank's experts: its slice of the routing (the backward
        # gathers the slices' gradients) and x's gradient summed over them
        combine = spmd.split(combine, 2, mesh)
        xin = spmd.copy(x, mesh)
    el = combine.shape[2]
    dispatch = (combine > 0).to(x.dtype)

    xe = torch.einsum("bsd,bsec->ebcd", xin, dispatch).reshape(el, b * cap, d)
    ye = nn.apply_mlp(params["experts"], xe, act, mpo, phase=phase)    # (E, B*C, D)
    y = torch.einsum("ebcd,bsec->bsd", ye.reshape(el, b, cap, d), combine)
    if mesh is not None:
        y = spmd.reduce(y, mesh)                   # the ranks' experts' shares

    # load-balance auxiliary loss (Switch-style)
    density = torch.nn.functional.one_hot(gate_idx[..., 0], e).float().mean((0, 1))
    density_proxy = probs.mean((0, 1))
    aux = e * (density * density_proxy).sum()
    return y.to(x.dtype), aux


def _whole_table(w):
    """The router's (D, E) table whole: on a mesh its experts' columns are
    gathered over ``model`` (its FSDP rows were gathered by
    ``spmd.localize``), so the logits are one device's bit for bit and
    top-k picks the same experts."""
    d = spmd.model_dim(w)
    if d is None:
        return spmd.local(w)
    return spmd.gather(spmd.local(w), d, w.device_mesh)


def _expert_mesh(experts: dict):
    """The mesh an expert stack is spread over along its expert dim
    (expert parallelism), or None (one device, or the stack
    tensor-parallel over its core 0 where E does not divide ``model``)."""
    up = experts["w_up"]
    leaf = up["w"] if "w" in up else up["cores"]["c0"]
    return leaf.device_mesh if spmd.model_dim(leaf) == 0 else None
