"""Logical-axis sharding rules with divisibility fallback — the port of
``repro.parallel.sharding``, onto ``torch.distributed`` ``DeviceMesh`` and
DTensor placements.

Every parameter carries a tuple of logical axis names (``layers.axes_for``).
``make_rules(mesh)`` maps logical names -> mesh axes; ``spec_for`` resolves
one leaf to the reference's ``PartitionSpec`` (a tuple here: one entry per
tensor dim, ``None``, an axis name or a tuple of names, trailing ``None``s
trimmed), falling back to replication for any dim whose size does not
divide the mesh-axis product (e.g. qwen3's 40 heads over model=16).
``placements(spec, mesh)`` turns a spec into DTensor placements, one per
mesh dim; ``tree_shardings`` / ``batch_sharding`` / ``cache_sharding``
return placement trees and ``place`` puts a tensor on the mesh by them.

The rule and spec functions read only ``mesh_dim_names`` and ``shape``, so a
duck-typed stand-in with those two attributes lints any mesh without a
process group.
"""

from __future__ import annotations

import math

import torch


def mesh_axis_sizes(mesh) -> dict:
    """mesh axis name -> size.  Reads only ``mesh_dim_names`` / ``shape``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def make_rules(mesh, *, fsdp: bool = True, sp: bool = False) -> dict:
    """logical axis name -> tuple of mesh axis names.

    ``sp=True`` switches to the sequence-parallel layout: weights are
    REPLICATED over `model` (MPO compression makes them small enough) and
    the `model` axis shards the activations' sequence dim instead — chosen
    for archs whose head counts don't divide the mesh."""
    multi_pod = "pod" in mesh.mesh_dim_names
    batch = ("pod", "data") if multi_pod else ("data",)
    tp = None if sp else ("model",)
    return {
        # ---- parameters ----
        "vocab": tp,
        "qkv": tp,               # flattened H*Dh projection dim
        "kv_qkv": tp,            # flattened KV*Dh projection dim
        "ffn": tp,
        "expert": ("model",),    # expert-parallel MoE (kept even under SP)
        "embed": ("data",) if fsdp else None,   # ZeRO-style param shard
        "bond": ("data",) if fsdp else None,    # central-core bond (FSDP)
        "layers": None,          # the stacked layer dim
        # ---- activations ----
        "batch": batch,
        "heads": tp,
        "act_seq": ("model",) if sp else None,
        "act_embed": None,
    }


def head_safe_rules(rules: dict, cfg, mesh) -> dict:
    """Drop the tensor-parallel rules of the flattened attention projections
    whose HEAD count does not divide the model-axis product: the flattened
    (H*Dh) dim usually IS divisible even when the head count is not, and its
    shards would then split ``head_dim`` across devices after the
    (B, S, H, Dh) reshape.  Replicating those two projections costs little:
    MPO compression keeps them small."""
    sizes = mesh_axis_sizes(mesh)

    def axis_prod(name):
        ax = rules.get(name)
        if ax is None:
            return 1
        ax = (ax,) if isinstance(ax, str) else ax
        return math.prod(sizes[a] for a in ax)

    out = dict(rules)
    if cfg.num_heads % max(axis_prod("qkv"), 1) != 0:
        out["qkv"] = None
    if cfg.num_kv_heads % max(axis_prod("kv_qkv"), 1) != 0:
        out["kv_qkv"] = None
    return out


def resolve_dims(axes: tuple, shape: tuple, rules: dict, sizes: dict) -> list:
    """Per-dim resolution with provenance: ``(mesh_axes | None, reason)``.

    ``reason`` is one of ``"sharded"`` (rule applied), ``"replicated"`` (no
    rule / explicit None), ``"indivisible"`` (rule present but the dim size
    doesn't divide the mesh-axis product — the silent fallback), or
    ``"axis_reused"`` (mesh axis already consumed by an earlier dim)."""
    used = set()
    out = []
    for dim, name in zip(shape, axes):
        mesh_axes = rules.get(name) if name is not None else None
        if mesh_axes is None:
            out.append((None, "replicated"))
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        prod = math.prod(sizes[a] for a in mesh_axes)
        if dim % prod != 0:
            out.append((None, "indivisible"))
            continue
        if any(a in used for a in mesh_axes):
            out.append((None, "axis_reused"))
            continue
        used.update(mesh_axes)
        out.append((mesh_axes, "sharded"))
    return out


def spec_for(axes: tuple, shape: tuple, rules: dict, mesh) -> tuple:
    """The reference's ``PartitionSpec`` as a tuple, with per-dim
    divisibility fallback and trailing ``None``s trimmed."""
    parts = []
    for mesh_axes, _ in resolve_dims(axes, shape, rules, mesh_axis_sizes(mesh)):
        if mesh_axes is None:
            parts.append(None)
        else:
            parts.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec``, one per mesh dim: ``Shard(d)`` on
    every mesh dim that tensor dim ``d`` is spread over (a dim over
    ``("pod", "data")`` gets two, major first), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_shardings(axes_tree, shape_tree, mesh, rules: dict):
    """Placement tree from (axes tuples, tensors or shapes)."""
    def one(sd, axes):
        shape = _shape(sd)
        return placements(spec_for(axes if axes is not None else (None,) * len(shape),
                                   shape, rules, mesh), mesh)
    return _tree_map(one, shape_tree, axes_tree)


def _batch_entry(rules: dict, sizes: dict):
    b = rules["batch"]
    b = (b,) if isinstance(b, str) else b
    return (b if len(b) > 1 else b[0]), math.prod(sizes[a] for a in b)


def batch_spec(shape: tuple, mesh, rules: dict) -> tuple:
    """An input's spec: dim 0 (the global batch) over the batch mesh axes,
    with the same divisibility fallback as params (batch 1 -> replicated)."""
    first, prod = _batch_entry(rules, mesh_axis_sizes(mesh))
    return (first,) if shape and shape[0] % prod == 0 else ()


def batch_sharding(batch_specs, mesh, rules: dict):
    """Placement tree of ``batch_spec`` for inputs (tensors or shapes)."""
    return _tree_map(lambda sd: placements(batch_spec(_shape(sd), mesh, rules), mesh),
                     batch_specs)


def cache_spec(name: str, shape: tuple, integer: bool, mesh, rules: dict) -> tuple:
    """One decode-cache leaf's spec (the reference's ``cache_sharding``).

    Integer leaves (per-slot positions, page tables, free lists) are tiny
    and replicated: every device needs every slot's position for masking
    and every page mapping for the gather.  Paged KV leaves (``k_pages`` /
    ``v_pages``: (L, pages, page_size, KV, Dh)) put the in-page sequence dim
    over ``model`` (else KV), the physical page dim unsharded.  A 5-D cache
    ((L, B, S, KV, Dh) K/V or (L, B, H, N, P) SSM state) puts the batch on
    the batch axes and ``model`` on the LARGEST divisible inner dim (for K/V
    the sequence: the flash-decoding layout); other caches of rank >= 2
    shard dim 0 over the batch axes."""
    sizes = mesh_axis_sizes(mesh)
    first, bprod = _batch_entry(rules, sizes)
    mprod = sizes.get("model", 1)
    parts = [None] * len(shape)
    if name in ("k_pages", "v_pages"):
        if shape[2] % mprod == 0:
            parts[2] = "model"
        elif shape[3] % mprod == 0:
            parts[3] = "model"
    elif integer:
        return ()
    elif len(shape) >= 5:
        if shape[1] % bprod == 0:
            parts[1] = first
        inner = [(shape[i], i) for i in range(2, len(shape) - 1) if shape[i] % mprod == 0]
        if inner:
            parts[max(inner)[1]] = "model"
    elif len(shape) >= 2 and shape[0] % bprod == 0:
        parts[0] = first
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def cache_sharding(cache_specs, mesh, rules: dict, name: str = ""):
    """Placement tree of ``cache_spec`` for a cache of tensors: one state
    tensor (the SSM family's), or dicts nested to any depth (the hybrid's
    ``{"kv": {k, v, pos}, "ssm"}``, encdec's ``{"self": {k, v, pos},
    "enc_out"}``), each leaf named by its own key."""
    if isinstance(cache_specs, dict):
        return {k: cache_sharding(v, mesh, rules, k) for k, v in cache_specs.items()}
    integer = not (cache_specs.dtype.is_floating_point or cache_specs.dtype.is_complex)
    return placements(cache_spec(name, tuple(cache_specs.shape), integer, mesh, rules), mesh)


def place(t: torch.Tensor, mesh, placements_):
    """``t`` (the whole tensor, the same on every rank) as a DTensor with
    ``placements_``: each rank keeps its own block, cut locally — nothing
    is sent — and copied to the rank's device (the card of a ``cuda``
    mesh), so a tree drawn whole on the host puts only its blocks on the
    card."""
    from torch.distributed.tensor import DTensor, Shard
    local = t
    coord = mesh.get_coordinate()
    for mdim, p in enumerate(placements_):
        if isinstance(p, Shard):
            n = mesh.size(mdim)
            chunk = local.shape[p.dim] // n
            local = local.narrow(p.dim, coord[mdim] * chunk, chunk)
    dev = (torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda"
           else torch.device(mesh.device_type))
    local = local.detach().to(dev, memory_format=torch.contiguous_format, copy=True)
    return DTensor.from_local(local, mesh, placements_, run_check=False, shape=t.shape,
                              stride=t.contiguous().stride())


def place_tree(tree, placement_tree, mesh):
    """``place`` over a tree (a dict of tensors, or one tensor)."""
    return _tree_map(lambda t, p: place(t, mesh, p), tree, placement_tree)


def constrain(x, mesh, rules: dict, names: tuple):
    """Redistribute a DTensor by logical activation names (the reference's
    ``with_sharding_constraint``); a plain tensor passes through."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(spec_for(names, tuple(x.shape), rules, mesh),
                                           mesh))
