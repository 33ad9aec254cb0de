"""Local SPMD: how the port's mesh path runs.

Parameters, serving weights and caches sit on the mesh as DTensors placed
by ``parallel.sharding``.  Every rank runs the same host loop and the same
model code on plain tensors: activations are whole over ``model`` (the
same on every rank of a ``model`` group; in serving, on every rank), and
the mesh enters at five kinds of point, each on LOCAL shards:

* tensor-parallel matrices (core 0's ``model``-sharded leg, or a dense W's
  ``model``-sharded dim): ``MPOEngine.linear`` runs the planned mode —
  ``kernel``, ``factorized`` or ``reconstruct`` — on the rank's block of W
  (core 0's legs are W's outermost digits, so a shard of core 0 is a valid
  MPO of a contiguous block of W), then ``gather`` (column-parallel: the
  output's columns) or ``reduce`` (row-parallel: partial sums) over
  ``model``.  ``copy`` and ``split`` are their inputs' counterparts, so the
  backward sums and gathers as Megatron's f / g operators do;
* expert parallelism: a MoE layer's expert stack spread over ``model``
  along its expert dim runs each rank's E/m experts whole on its slice of
  the dispatch (``MPOEngine.linear``'s ``expert`` role), and
  ``models.moe`` sums the combine over ``model`` (``reduce``); the router
  table is gathered whole, so routing is one device's;
* FSDP (``data``-sharded) leaves — the central core's bond, norm scales —
  are gathered at a step's entry (``localize``), the backward keeping the
  rank's own slice;
* a train step's batch: its rows are spread over the batch axes
  (``parallel.sharding.batch_sharding``), each rank runs its own rows
  (``take_rows``), and the gradients are summed over those axes
  (``sum_grads``, and ``localize``'s FSDP gathers, whose backward then
  reduce-scatters);
* the caches: each rank writes the rows it owns (``local_range``), and
  attention over a sequence-sharded cache combines per-rank partial
  softmaxes over ``model`` (``combine_softmax``), then gathers the batch
  rows over ``data``.

The hand-written kernels only ever see plain local tensors (each wrapper
refuses a DTensor).  With every mesh axis of size one — one card — each
collective is skipped and the local tensors are the whole ones.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _dtensor_cls():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(t) -> bool:
    return dist.is_available() and isinstance(t, _dtensor_cls())


# --------------------------------------------------------------------------
# placements
# --------------------------------------------------------------------------


def shard_dims(t) -> dict:
    """{tensor dim: [mesh dim names over it, major first]} of a DTensor."""
    from torch.distributed.tensor import Shard
    out: dict = {}
    names = t.device_mesh.mesh_dim_names
    for mdim, p in enumerate(t.placements):
        if isinstance(p, Shard):
            out.setdefault(p.dim % t.dim(), []).append(names[mdim])
    return out


def model_dim(t) -> int | None:
    """The tensor dim a DTensor spreads over the ``model`` axis, or None
    (also for a plain tensor)."""
    if not is_dtensor(t):
        return None
    for d, names in shard_dims(t).items():
        if "model" in names:
            return d
    return None


def local_range(t, dim: int) -> tuple[int, int]:
    """[lo, hi) of tensor dim ``dim`` this rank holds (the whole dim for a
    plain tensor)."""
    size = t.shape[dim]
    if not is_dtensor(t):
        return 0, size
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    lo, chunk = 0, size
    for mdim, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim % t.dim() == dim % t.dim():
            chunk //= mesh.size(mdim)
            lo += coord[mdim] * chunk
    return lo, lo + chunk


def local(t):
    """The rank's block of a DTensor (a view of its storage); a plain tensor
    as it is."""
    return t.to_local() if is_dtensor(t) else t


def localize(tree, batch_axes: tuple = ()):
    """A params tree for the model code: leaves spread over ``model`` stay
    DTensors (``MPOEngine`` runs them on their local shards), their other
    shards gathered (an expert stack's central core: its experts over
    ``model``, its bond over ``data``); every other leaf becomes a plain
    whole tensor — its local block where it is replicated, gathered where
    it is ``data``-sharded (FSDP).  All are differentiable back into the
    DTensor leaf.  With ``batch_axes`` (a train step whose rows are spread
    over them) a gathered leaf's gradient is summed over those axes on its
    way back to the shards (a reduce-scatter)."""
    if isinstance(tree, dict):
        return {k: localize(v, batch_axes) for k, v in tree.items()}
    if not is_dtensor(tree):
        return tree
    if model_dim(tree) is not None:
        return _gather_beside_model(tree, batch_axes)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = tree.device_mesh
    if any(isinstance(p, Shard) and mesh.size(i) > 1 for i, p in enumerate(tree.placements)):
        return tree.full_tensor(grad_placements=[
            Partial() if n in batch_axes else Replicate() for n in mesh.mesh_dim_names])
    return tree.to_local()


def _gather_beside_model(t, batch_axes: tuple):
    """A ``model``-sharded DTensor with its shards over the other mesh axes
    gathered (minor axis first): the same leaf spread over ``model`` alone.
    The gradient goes back to the rank's own slice, summed first over the
    axes in ``batch_axes``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, names = t.device_mesh, t.device_mesh.mesh_dim_names
    others = [i for i, p in enumerate(t.placements) if isinstance(p, Shard)
              and names[i] != "model" and mesh.size(i) > 1]
    if not others:
        return t
    x = t.to_local()
    for i in reversed(others):
        x = _Gather.apply(x, t.placements[i].dim % t.dim(), mesh, names[i],
                          names[i] in batch_axes)
    kept = tuple(Replicate() if i in others else p for i, p in enumerate(t.placements))
    return DTensor.from_local(x, mesh, kept, run_check=False, shape=t.shape,
                              stride=t.stride())


def cache_views(cache, *, all_leaves: bool = False):
    """A cache for the model code: its integer leaves (positions, page
    tables, free lists — replicated) as plain views of their storage, so the
    model's in-place bookkeeping runs as on one device; float leaves stay
    DTensors (the attention and SSM code write their local blocks), or with
    ``all_leaves`` become their local blocks too (``reset_cache``)."""
    if isinstance(cache, dict):
        return {k: cache_views(v, all_leaves=all_leaves) for k, v in cache.items()}
    if not is_dtensor(cache) or (cache.dtype.is_floating_point and not all_leaves):
        return cache
    return cache.to_local()


# --------------------------------------------------------------------------
# collectives over one mesh axis, autograd-aware
# --------------------------------------------------------------------------


def _axis(mesh, name: str):
    """(process group, size, this rank's coordinate) of mesh axis ``name``."""
    i = mesh.mesh_dim_names.index(name)
    return mesh.get_group(i), mesh.size(i), mesh.get_coordinate()[i]


def _all_gather(x, dim, group, n):
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def _slice(x, dim, n, r):
    chunk = x.shape[dim] // n
    return x.narrow(dim, r * chunk, chunk).contiguous()


class _Gather(torch.autograd.Function):
    """Forward: concatenate every rank's ``x`` along ``dim``.  Backward:
    the rank's own slice (the result is used the same on every rank), or
    with ``summed`` the slice of the gradients summed over the axis (each
    rank used the result on rows of its own)."""

    @staticmethod
    def forward(ctx, x, dim, mesh, name, summed=False):
        group, n, r = _axis(mesh, name)
        ctx.args = (dim, n, r, group if summed else None)
        return _all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, dy):
        dim, n, r, group = ctx.args
        if group is not None:
            dy = _all_reduce(dy, group)
        return _slice(dy, dim, n, r), None, None, None, None


class _Reduce(torch.autograd.Function):
    """Forward: sum over the axis.  Backward: identity."""

    @staticmethod
    def forward(ctx, x, mesh, name):
        return _all_reduce(x, _axis(mesh, name)[0])

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


class _Copy(torch.autograd.Function):
    """Forward: identity.  Backward: sum over the axis (each rank's
    column block contributes to the input's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.args = (mesh, name)
        return x

    @staticmethod
    def backward(ctx, dy):
        mesh, name = ctx.args
        return _all_reduce(dy, _axis(mesh, name)[0]), None, None


class _Split(torch.autograd.Function):
    """Forward: the rank's slice of ``dim``.  Backward: gather the slices."""

    @staticmethod
    def forward(ctx, x, dim, mesh, name):
        group, n, r = _axis(mesh, name)
        ctx.args = (dim, group, n)
        return _slice(x, dim, n, r)

    @staticmethod
    def backward(ctx, dy):
        dim, group, n = ctx.args
        return _all_gather(dy, dim, group, n), None, None, None


def _trivial(mesh, name) -> bool:
    return name not in mesh.mesh_dim_names or mesh.size(
        mesh.mesh_dim_names.index(name)) == 1


def gather(x, dim: int, mesh, name: str = "model"):
    return x if _trivial(mesh, name) else _Gather.apply(x, dim % x.dim(), mesh, name)


def reduce(x, mesh, name: str = "model"):
    return x if _trivial(mesh, name) else _Reduce.apply(x, mesh, name)


def copy(x, mesh, name: str = "model"):
    return x if _trivial(mesh, name) else _Copy.apply(x, mesh, name)


def split(x, dim: int, mesh, name: str = "model"):
    return x if _trivial(mesh, name) else _Split.apply(x, dim % x.dim(), mesh, name)


def all_max(x, mesh, name: str = "model"):
    """Elementwise max over the axis (no gradient: a softmax shift)."""
    if _trivial(mesh, name):
        return x
    return _all_reduce(x.detach(), _axis(mesh, name)[0], dist.ReduceOp.MAX)


# --------------------------------------------------------------------------
# a train step's batch over the batch axes
# --------------------------------------------------------------------------


def take_rows(batch: dict, placements_: dict, mesh):
    """``(rows, axes)``: the rank's rows of a batch that every rank holds
    whole (a view), by its placement tree
    (``parallel.sharding.batch_sharding``), and the mesh axes of more than
    one rank that spread them — ``()`` where the rows do not divide."""
    from torch.distributed.tensor import Shard
    first = next(iter(placements_.values()))
    axes = tuple(n for i, (n, p) in enumerate(zip(mesh.mesh_dim_names, first))
                 if isinstance(p, Shard) and mesh.size(i) > 1)
    if not axes:
        return batch, ()
    coord = mesh.get_coordinate()
    out = {}
    for k, t in batch.items():
        for i, p in enumerate(placements_[k]):
            if isinstance(p, Shard) and mesh.size(i) > 1:
                chunk = t.shape[p.dim] // mesh.size(i)
                t = t.narrow(p.dim, coord[i] * chunk, chunk)
        out[k] = t
    return out, axes


def sum_grads(grads, params, axes: tuple, mesh) -> None:
    """Sum, in place over the mesh ``axes``, the gradients of the
    parameters those axes do not shard (the others came back summed
    through ``localize``'s gathers).  ``None`` (a frozen leaf) is left."""
    from torch.distributed.tensor import Shard
    names = mesh.mesh_dim_names
    for g, p in zip(grads, params):
        if g is None:
            continue
        lg = local(g)
        for n in axes:
            i = names.index(n)
            if not (is_dtensor(p) and isinstance(p.placements[i], Shard)):
                dist.all_reduce(lg, group=mesh.get_group(i))


def all_sum(x, mesh, axes: tuple):
    """A plain tensor's sum over the mesh ``axes`` (no gradient)."""
    for n in axes:
        x = _all_reduce(x.detach(), mesh.get_group(mesh.mesh_dim_names.index(n)))
    return x


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------


def write_block(dst, whole) -> None:
    """``dst.copy_(whole)`` of a cache leaf; on a mesh each rank writes its
    own block of ``whole`` (the same on every rank)."""
    idx = tuple(slice(*local_range(dst, d)) for d in range(dst.dim()))
    local(dst).copy_(whole[idx])


def sharded_over(t, dim: int, name: str) -> bool:
    """Whether a DTensor spreads tensor dim ``dim`` over mesh axis ``name``
    of more than one rank (an axis of one splits nothing)."""
    return (is_dtensor(t) and name in shard_dims(t).get(dim % t.dim(), [])
            and not _trivial(t.device_mesh, name))


def gather_batch(y, dim: int, t):
    """Gather ``y``'s dim ``dim`` over the non-``model`` mesh axes that
    cache leaf ``t`` spreads its batch dim over (minor axis first), so every
    rank ends with every row."""
    if not is_dtensor(t):
        return y
    names = [n for n in shard_dims(t).get(dim % t.dim(), []) if n != "model"]
    for name in reversed(names):
        y = gather(y, dim, t.device_mesh, name)
    return y


def combine_softmax(o, m, l, mesh, name: str = "model"):
    """Merge per-rank partial softmaxes over ``name``: ``o`` = sum_j
    exp(s_j - m) v_j and ``l`` = sum_j exp(s_j - m) over the rank's keys,
    ``m`` the rank's max score (all f32, ``m`` / ``l`` broadcastable to
    ``o``).  Returns sum_r o_r e^(m_r - M) / sum_r l_r e^(m_r - M), M the
    max over ranks — the softmax over every rank's keys (zero where no rank
    has a key)."""
    if _trivial(mesh, name):
        return o / l.clamp(min=1e-30)
    big = all_max(m, mesh, name)
    scale = torch.exp(m - big)
    return reduce(o * scale, mesh, name) / reduce(l * scale, mesh, name).clamp(min=1e-30)
