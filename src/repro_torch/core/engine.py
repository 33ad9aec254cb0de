"""MPO execution engine: phase-aware planning + serving weight cache.

The port of ``repro.core.engine``.  An MPO-factorized matrix executes one of
four ways:

  mode          what runs                                  when it wins
  ------------  -----------------------------------------  ---------------------
  factorized    sequential chain contraction               memory-bound / heavily
                (``mpo.apply_mpo``)                        truncated bonds
  reconstruct   contract cores -> dense W, matmul          compute-bound shapes
                (``mpo.matmul_reconstruct``)
  kernel        fused on-chip rebuild + matmul CUDA        dense-favored shapes on
                kernels, forward and backward — W and dW   the card (serving and
                never reach device memory                  training alike)
                (``kernels.mpo_linear.MPOLinearFn``)
  cached        dense W contracted ONCE at serving init    decode: the rebuild is
                and reused for every step                  amortized to zero

``ExecutionPlan`` is one immutable, memoized decision per (core shapes,
token count, phase, device type, dtype).  The device plays the part of the
reference's ``interpret`` flag: a plan may resolve to ``kernel`` only for a
CUDA device, as the reference allows it only when ``interpret`` is False.
``train`` and ``prefill`` ask the measured autotuner (``kernels.autotune``)
first where it measures — for a CUDA device the process has, or wherever
``REPRO_TORCH_AUTOTUNE_MEASURE=1`` — and take its mode and row tile
(``block_m``); elsewhere, and with ``REPRO_TORCH_AUTOTUNE_MEASURE=0``,
planning is analytic (FLOPs, then the kernels' gate), so on the CPU the
port makes the reference's interpret-mode decisions exactly.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import torch

from repro_torch.core import layers, mpo
from repro_torch.kernels import autotune
from repro_torch.kernels.mpo_linear import MPOLinearFn, kernel_eligible

PHASES = ("train", "prefill", "decode")


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (plans key on the name)."""
    return dtype if isinstance(dtype, str) else str(dtype).removeprefix("torch.")


# --------------------------------------------------------------------------
# cost model
# --------------------------------------------------------------------------


def flops_factorized_per_token(shapes: Sequence[tuple]) -> int:
    """FLOPs/token of the sequential contraction in ``mpo.apply_mpo``."""
    ins = [s[1] for s in shapes]
    total, rest = 0, math.prod(ins)
    out_done = 1
    for (d0, ik, jk, d1) in shapes:
        rest //= ik
        total += 2 * out_done * d0 * ik * rest * jk * d1
        out_done *= jk
    return total


def flops_reconstruct(shapes: Sequence[tuple]) -> int:
    """One-time FLOPs to contract the cores into W."""
    total = 0
    acc_rows = shapes[0][1] * shapes[0][2]
    for (d0, ik, jk, d1) in shapes[1:]:
        total += 2 * acc_rows * d0 * ik * jk * d1
        acc_rows *= ik * jk
    return total


def flops_dense_per_token(shapes: Sequence[tuple]) -> int:
    """FLOPs/token of the dense ``x @ W`` matmul once W exists."""
    return 2 * math.prod(s[1] for s in shapes) * math.prod(s[2] for s in shapes)


# --------------------------------------------------------------------------
# planning
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Immutable decision record for one (matrix, workload) pairing::

        plan = engine_for(cfg.mpo).plan(shapes, tokens=1, phase="decode")
        plan.mode        # "cached" | "factorized" | ...
        plan.reason      # human-readable why, e.g. the FLOPs comparison
    """

    mode: str                      # factorized | reconstruct | kernel | cached
    phase: str                     # train | prefill | decode
    shapes: tuple                  # core shapes ((d0, i, j, d1), ...)
    tokens: int                    # tokens per call this plan was sized for
    flops_factorized: int          # per-token chain cost
    flops_dense: int               # per-token dense matmul cost
    flops_rebuild: int             # one-time cores -> W cost
    block_m: int = 0               # kernel row tile (measured when tuned); 0: its plan's own
    device: str = "cpu"            # device type the plan was made for
    dtype: str = "float32"         # activation dtype the plan was sized for
    tuned: bool = False            # mode and block_m came from a measurement
    reason: str = ""               # human-readable why (for tests/debug)


def _decide(cfg, shapes: tuple, tokens: int, phase: str, device: str,
            dtype: str) -> tuple[str, int, bool, str]:
    """(mode, block_m, tuned, reason) — the full planning decision.

    ``train`` and ``prefill`` first consult the measured autotuner where it
    measures (``autotune.should_measure``); a kernel candidate that fails
    raises out of planning, never hands the choice to another mode.  Else
    the analytic FLOPs comparison and the kernels' gate decide.
    ``decode``'s cached-vs-factorized choice stays analytic: it is a memory
    policy (never resurrect a heavily compressed table as a dense W), not a
    latency race."""
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r} (expected one of {PHASES})")
    if cfg.mode != "auto":
        return cfg.mode, 0, False, f"forced by cfg.mode={cfg.mode!r}"
    fact_tok = flops_factorized_per_token(shapes)
    dense_tok = flops_dense_per_token(shapes)
    rebuild = flops_reconstruct(shapes)
    if phase == "decode":
        # the one-time rebuild happens at serving init (cache_weights) and is
        # amortized over the whole generation -> steady-state FLOPs decide
        if dense_tok < fact_tok:
            return "cached", 0, False, (f"dense {dense_tok} < factorized {fact_tok} "
                                        "FLOPs/token; rebuild amortized at cache init")
        return "factorized", 0, False, (f"factorized {fact_tok} <= dense {dense_tok} "
                                        "FLOPs/token; caching W would also cost I*J memory")
    if autotune.should_measure(device):
        res = autotune.get_tuner().get(shapes, tokens, phase, dtype, device)
        return res.mode, res.block_m, True, (
            f"autotuned ({res.source}): {res.mode}@{res.block_m} fastest of "
            f"{len(res.timings)} candidates")
    cost_fact = tokens * fact_tok
    cost_recon = rebuild + tokens * dense_tok
    if cost_fact < cost_recon:
        return "factorized", 0, False, (f"chain {cost_fact} < rebuild+dense "
                                        f"{cost_recon} FLOPs at {tokens} tokens")
    if device == "cuda" and kernel_eligible(shapes, dtype=dtype,
                                            train=phase == "train"):
        what = "fwd+bwd" if phase == "train" else "forward-only"
        return "kernel", 0, False, (f"dense-favored {what} phase on the card: fuse the "
                                    "rebuild on chip (analytic gate; not measured)")
    return "reconstruct", 0, False, (f"rebuild+dense {cost_recon} <= chain {cost_fact} "
                                     f"FLOPs at {tokens} tokens")


def choose_mode(cfg, shapes: Sequence[tuple], tokens: int, phase: str, *,
                device="cpu", dtype="float32") -> tuple[str, str]:
    """(mode, reason) for one matrix execution; a non-"auto" ``cfg.mode``
    always wins.  ``device`` is a device or its type ("cpu", "cuda"): the
    decision is pure Python and needs no card::

        mode, why = choose_mode(MPOConfig(), shapes, tokens=1024,
                                phase="prefill", device="cuda")
    """
    shapes = tuple(tuple(int(d) for d in s) for s in shapes)
    mode, _, _, reason = _decide(cfg, shapes, tokens, phase, torch.device(device).type,
                                 dtype_name(dtype))
    return mode, reason


@functools.lru_cache(maxsize=None)
def _plan(cfg, shapes: tuple, tokens: int, phase: str, device: str,
          dtype: str) -> ExecutionPlan:
    mode, block_m, tuned, reason = _decide(cfg, shapes, tokens, phase, device, dtype)
    return ExecutionPlan(
        mode=mode, phase=phase, shapes=shapes, tokens=tokens,
        flops_factorized=flops_factorized_per_token(shapes),
        flops_dense=flops_dense_per_token(shapes),
        flops_rebuild=flops_reconstruct(shapes),
        block_m=block_m, device=device, dtype=dtype, tuned=tuned, reason=reason)


def clear_plan_cache() -> None:
    """Drop every memoized ``ExecutionPlan`` (needed after
    ``autotune.reset_tuner`` or a change of ``REPRO_TORCH_AUTOTUNE_MEASURE``
    for planning to consult the tuner again)."""
    _plan.cache_clear()


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------


class MPOEngine:
    """Execution engine for every MPO-factorized matrix under one
    ``MPOConfig``: plan lookup, mode dispatch, the serving-time weight
    cache, and master-weight -> activation dtype casting.  Stateless apart
    from the config (plans are memoized process-wide)::

        eng = engine_for(cfg.mpo)
        y = eng.linear(params["w_up"], x, phase="prefill")   # planned matmul
        logits = eng.logits(params["embed"], h)               # tied head
        dense = eng.cache_weights(params)                     # decode snapshot
    """

    def __init__(self, cfg):
        self.cfg = cfg

    def plan(self, shapes: Sequence[tuple], tokens: int, phase: str,
             dtype="float32", device="cpu") -> ExecutionPlan:
        """The (memoized) plan for one matrix at one workload point."""
        return _plan(self.cfg, tuple(tuple(int(d) for d in s) for s in shapes),
                     int(tokens), phase, torch.device(device).type,
                     dtype_name(dtype))

    def _prepare_cores(self, params: dict, dtype) -> list[torch.Tensor]:
        """The one place the activation-dtype cast and ``freeze_central_grads``
        happen: a frozen central core is detached, so its gradient is zero
        (the train step fills None with zeros), as the reference's
        ``stop_gradient`` makes it."""
        cores = layers.cores_to_list(params["cores"])
        if dtype is not None:
            cores = [c.to(dtype) for c in cores]
        if self.cfg.freeze_central_grads:
            mid = len(cores) // 2
            cores[mid] = cores[mid].detach()
        return cores

    def linear(self, params: dict, x: torch.Tensor, *, transpose: bool = False,
               phase: str = "train") -> torch.Tensor:
        """``y = x @ W`` (or ``x @ W^T``) through the planned mode.

        Master weights stay f32 and are cast to the activation dtype at the
        point of use.  A dense ``{"w": ...}`` entry — a never-factorized
        matrix or a serving-time cached W — short-circuits before planning.
        The ``kernel`` mode runs at the plan's row tile (``block_m``).

        A stack of E matrices of one shape (the experts of a MoE layer: cores
        ``(E, d0, i, j, d1)``, x ``(E, N, I)``) is planned per matrix at N
        tokens, as the reference's ``jax.vmap`` over the experts shows its
        engine (and its tuner) one matrix at a time, and all E run in one call
        of the planned mode: on the card one forward launch, and in training
        one call of the cores backward (``MPOLinearFn`` over the stack)."""
        if _on_mesh(params):
            return self._mesh_linear(params, x, transpose=transpose, phase=phase)
        if "w" in params:
            w = params["w"].to(x.dtype)
            return x @ (w.T if transpose else w)
        cores = self._prepare_cores(params, x.dtype)
        if transpose:
            cores = mpo.transpose_cores(cores)
        lead = cores[0].dim() - 4                  # 1 over an expert stack
        tokens = math.prod(x.shape[lead:-1]) if x.dim() > 1 else 1
        shapes = [c.shape[-4:] for c in cores]
        plan = self.plan(shapes, tokens, phase, x.dtype, x.device)
        if plan.mode == "cached" and self.cfg.mode == "auto":
            # "cached" assumes the rebuild was amortized at cache init, but
            # the caller passed raw cores: re-decide as a one-shot forward
            plan = self.plan(shapes, tokens, "prefill", x.dtype, x.device)
        if plan.mode == "kernel":
            return MPOLinearFn.apply(x.contiguous(), plan.block_m,
                                     *[c.contiguous() for c in cores])
        if plan.mode == "factorized":
            return torch.vmap(mpo.apply_mpo)(cores, x) if lead else mpo.apply_mpo(cores, x)
        # "reconstruct" (or a forced "cached" over raw cores: contract now)
        return mpo.matmul_reconstruct(x, cores)

    def _mesh_linear(self, params: dict, x: torch.Tensor, *, transpose: bool,
                     phase: str) -> torch.Tensor:
        """``linear`` over a matrix on a mesh (``parallel.spmd``): the
        planned mode runs on the rank's block of W, planned at the block's
        shapes; x is whole and the same on every rank, and so is the
        result.  A ``j`` (output) shard is column-parallel: the blocks'
        columns are gathered over ``model``.  An ``i`` (input) shard is
        row-parallel: x's matching slice goes in and the partial sums are
        added over ``model``.  A stack spread over ``model`` along its
        expert dim (expert parallelism) runs the rank's E/m experts whole on
        the x rows the caller gives them, with no collective.  FSDP leaves
        (the central core's bond) are gathered first; a matrix with no
        ``model`` shard runs whole.  The cores the ranks share enter through
        ``spmd.copy``: each rank's block adds its part to their gradients,
        summed over ``model``."""
        from repro_torch.parallel import spmd
        role, mesh = _tp_role(params)
        local = {k: ({n: _whole(c) for n, c in v.items()} if k == "cores" else _whole(v))
                 for k, v in params.items()}
        if role is None or role == "expert":
            # an expert stack spread over `model`: the rank's own experts,
            # whole, on its own tokens (x is the rank's slice of the
            # dispatch; models.moe sums the combine over `model`)
            return self.linear(local, x, transpose=transpose, phase=phase)
        if "cores" in local:
            local["cores"] = {n: c if spmd.model_dim(params["cores"][n]) is not None
                              else spmd.copy(c, mesh) for n, c in local["cores"].items()}
        if transpose:
            role = "row" if role == "col" else "col"
        if role == "col":
            y = self.linear(local, spmd.copy(x, mesh), transpose=transpose, phase=phase)
            return spmd.gather(y, -1, mesh)
        y = self.linear(local, spmd.split(x, -1, mesh), transpose=transpose, phase=phase)
        return spmd.reduce(y, mesh)

    def logits(self, params: dict, h: torch.Tensor, *,
               phase: str = "train") -> torch.Tensor:
        """Tied-embedding output head: ``h @ E^T``."""
        return self.linear(params, h, transpose=True, phase=phase)

    def embedding(self, params: dict, ids: torch.Tensor, *, dtype=None,
                  phase: str = "train") -> torch.Tensor:
        """Row lookup ``W[ids, :]`` — dense take or the factorized chain.
        ``phase`` is accepted for interface uniformity: a lookup has one
        realization, so no plan is consulted."""
        if _on_mesh(params):
            return self._mesh_embedding(params, ids, dtype=dtype, phase=phase)
        if "w" in params:
            w = params["w"] if dtype is None else params["w"].to(dtype)
            return w[ids.long()]
        return mpo.embed_lookup(self._prepare_cores(params, dtype), ids)

    def _mesh_embedding(self, params: dict, ids: torch.Tensor, *, dtype, phase: str):
        """``embedding`` on a mesh: a dense table spread over ``model``
        along the vocabulary looks up the ids of the rank's rows (zeros
        elsewhere) and sums over ``model``; anything else is gathered of its
        FSDP shards and looked up whole."""
        from repro_torch.parallel import spmd
        role, mesh = _tp_role(params)
        if role is None:
            local = {k: ({n: _whole(c) for n, c in v.items()} if k == "cores" else _whole(v))
                     for k, v in params.items()}
            return self.embedding(local, ids, dtype=dtype, phase=phase)
        if "w" not in params or role != "row":
            raise NotImplementedError("a factorized embedding is replicated over "
                                      "`model` (layers.init_embedding)")
        w = params["w"]
        lo, hi = spmd.local_range(w, w.dim() - 2)
        wl = spmd.local(w) if dtype is None else spmd.local(w).to(dtype)
        ids = ids.long()
        mine = (ids >= lo) & (ids < hi)
        rows = wl[torch.where(mine, ids - lo, 0)] * mine[..., None].to(wl.dtype)
        return spmd.reduce(rows, mesh)

    def cache_weights(self, params, *, dtype=None, axes=None):
        """One-time densification at serving init (next to the KV cache).

        Returns a new params tree where every factorized matrix whose decode
        plan is ``cached`` is replaced by its contracted dense ``{"w": W}``
        in ``dtype`` (the cores' float32 when None); everything else passes
        through untouched.  Each matrix of a stack (leading layer and
        expert dims) is contracted on its own into one preallocated
        ``(L, I, J)`` (``(L, E, I, J)``) tensor
        (``mpo.reconstruct_stacked``), so the peak above the result is one
        layer's float32 W.  W rounded to
        the activation dtype here has the bits the cast at every use
        (``linear``, ``embedding``) would give it.  The result is a SNAPSHOT:
        re-run after any core mutation.

        With ``axes`` (the logical-axis tree, ``layers.axes_for``) returns
        ``(params, axes)``: a dense W inherits its cores' tensor-parallel
        layout (``_dense_axes_from_cores``), so ``parallel.sharding`` places
        it where the cores' shards lived."""
        def visit(node, ax):
            if not isinstance(node, dict):
                return node, ax
            if "cores" in node:
                cores = layers.cores_to_list(node["cores"])
                shapes = tuple(tuple(c.shape[-4:]) for c in cores)
                if self.plan(shapes, 1, "decode").mode != "cached":
                    return node, ax
                w = {"w": mpo.reconstruct_stacked(cores, dtype)}
                if ax is None:
                    return w, None
                names = layers.core_names(len(cores))
                return w, {"w": _dense_axes_from_cores([ax["cores"][n] for n in names])}
            pairs = {k: visit(v, None if ax is None else ax[k]) for k, v in node.items()}
            return ({k: p for k, (p, _) in pairs.items()},
                    None if ax is None else {k: a for k, (_, a) in pairs.items()})

        new_params, new_axes = visit(params, axes)
        return new_params if axes is None else (new_params, new_axes)


def _dense_axes_from_cores(core_axes: Sequence[tuple]) -> tuple:
    """Logical axes of the contracted dense W, inherited from its cores.

    Each core's trailing four legs are (bond, i, j, bond); W's in/out dims
    take the first non-``None`` name found on any core's i/j leg (at most one
    core carries the tensor-parallel annotation).  Leading stacked dims
    (layers, experts) keep their names.  Bond-leg names (the central core's
    FSDP ``"bond"``) do not survive: the bond dim is contracted away."""
    lead = tuple(core_axes[0][:-4])
    in_axis = next((a[-3] for a in core_axes if a[-3] is not None), None)
    out_axis = next((a[-2] for a in core_axes if a[-2] is not None), None)
    return lead + (in_axis, out_axis)


def _on_mesh(params: dict) -> bool:
    """Whether a matrix's leaves are DTensors (it sits on a mesh)."""
    from repro_torch.parallel.spmd import is_dtensor
    leaf = params["w"] if "w" in params else next(iter(params["cores"].values()))
    return is_dtensor(leaf)


def _whole(t):
    """A matrix leaf for the local computation: a ``model``-sharded DTensor
    as its local block, anything else whole (FSDP shards gathered)."""
    from repro_torch.parallel import spmd
    if not spmd.is_dtensor(t):
        return t
    return spmd.local(t) if spmd.model_dim(t) is not None else spmd.localize(t)


def _tp_role(params: dict):
    """("col" | "row" | "expert" | None, mesh) of a matrix on a mesh: which
    of W's dims its ``model`` shard cuts — the output (j), the input (i),
    or a stack dim (a MoE layer's experts: each rank holds E/m whole
    matrices).  Of W's own dims only core 0's legs (``shard_leg="first"``)
    give each rank a contiguous block of W."""
    from repro_torch.parallel import spmd
    if "w" in params:
        named = [("w", params["w"])]
    else:
        named = list(params["cores"].items())
    for name, t in named:
        d = spmd.model_dim(t)
        if d is None:
            continue
        lead = t.dim() - (2 if name == "w" else 4)       # the stack's dims
        if d < lead:
            return "expert", t.device_mesh
        if name not in ("w", "c0"):
            raise NotImplementedError(
                f"core {name!r} is sharded over `model`: only core 0's legs "
                "(shard_leg='first') give each rank a block of W")
        i_leg = lead + (0 if name == "w" else 1)
        return ("row" if d == i_leg else "col"), t.device_mesh
    return None, None


@functools.lru_cache(maxsize=None)
def engine_for(cfg) -> MPOEngine:
    """Shared engine instance per (hashable, frozen) ``MPOConfig``."""
    return MPOEngine(cfg)
