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
CUDA device, as the reference allows it only when ``interpret`` is False, so
on the CPU the port makes the reference's interpret-mode decisions exactly.
Planning is analytic (FLOPs); measured autotuning comes with
``kernels/autotune`` (ROADMAP.md, Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import torch

from repro_torch.core import layers, mpo
from repro_torch.kernels.mpo_linear import kernel_eligible

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
    device: str = "cpu"            # device type the plan was made for
    dtype: str = "float32"         # activation dtype the plan was sized for
    reason: str = ""               # human-readable why (for tests/debug)


def _decide(cfg, shapes: tuple, tokens: int, phase: str, device: str,
            dtype: str) -> tuple[str, str]:
    """(mode, reason) — the full planning decision."""
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r} (expected one of {PHASES})")
    if cfg.mode != "auto":
        return cfg.mode, f"forced by cfg.mode={cfg.mode!r}"
    fact_tok = flops_factorized_per_token(shapes)
    dense_tok = flops_dense_per_token(shapes)
    rebuild = flops_reconstruct(shapes)
    if phase == "decode":
        # the one-time rebuild happens at serving init (cache_weights) and is
        # amortized over the whole generation -> steady-state FLOPs decide
        if dense_tok < fact_tok:
            return "cached", (f"dense {dense_tok} < factorized {fact_tok} "
                              "FLOPs/token; rebuild amortized at cache init")
        return "factorized", (f"factorized {fact_tok} <= dense {dense_tok} "
                              "FLOPs/token; caching W would also cost I*J memory")
    cost_fact = tokens * fact_tok
    cost_recon = rebuild + tokens * dense_tok
    if cost_fact < cost_recon:
        return "factorized", (f"chain {cost_fact} < rebuild+dense "
                              f"{cost_recon} FLOPs at {tokens} tokens")
    if device == "cuda" and kernel_eligible(shapes, dtype=dtype,
                                            train=phase == "train"):
        what = "fwd+bwd" if phase == "train" else "forward-only"
        return "kernel", (f"dense-favored {what} phase on the card: fuse the "
                          "rebuild on chip (analytic gate)")
    return "reconstruct", (f"rebuild+dense {cost_recon} <= chain {cost_fact} "
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
    return _decide(cfg, shapes, tokens, phase, torch.device(device).type,
                   dtype_name(dtype))


@functools.lru_cache(maxsize=None)
def _plan(cfg, shapes: tuple, tokens: int, phase: str, device: str,
          dtype: str) -> ExecutionPlan:
    mode, reason = _decide(cfg, shapes, tokens, phase, device, dtype)
    return ExecutionPlan(
        mode=mode, phase=phase, shapes=shapes, tokens=tokens,
        flops_factorized=flops_factorized_per_token(shapes),
        flops_dense=flops_dense_per_token(shapes),
        flops_rebuild=flops_reconstruct(shapes),
        device=device, dtype=dtype, reason=reason)


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
        matrix or a serving-time cached W — short-circuits before planning."""
        if "w" in params:
            w = params["w"].to(x.dtype)
            return x @ (w.T if transpose else w)
        cores = self._prepare_cores(params, x.dtype)
        if transpose:
            cores = mpo.transpose_cores(cores)
        tokens = math.prod(x.shape[:-1]) if x.dim() > 1 else 1
        shapes = [c.shape for c in cores]
        plan = self.plan(shapes, tokens, phase, x.dtype, x.device)
        if plan.mode == "cached" and self.cfg.mode == "auto":
            # "cached" assumes the rebuild was amortized at cache init, but
            # the caller passed raw cores: re-decide as a one-shot forward
            plan = self.plan(shapes, tokens, "prefill", x.dtype, x.device)
        if plan.mode == "kernel":
            from repro_torch.kernels.mpo_linear import MPOLinearFn
            return MPOLinearFn.apply(x.contiguous(), *[c.contiguous() for c in cores])
        if plan.mode == "factorized":
            return mpo.apply_mpo(cores, x)
        # "reconstruct" (or a forced "cached" over raw cores: contract now)
        return mpo.matmul_reconstruct(x, cores)

    def logits(self, params: dict, h: torch.Tensor, *,
               phase: str = "train") -> torch.Tensor:
        """Tied-embedding output head: ``h @ E^T``."""
        return self.linear(params, h, transpose=True, phase=phase)

    def embedding(self, params: dict, ids: torch.Tensor, *, dtype=None,
                  phase: str = "train") -> torch.Tensor:
        """Row lookup ``W[ids, :]`` — dense take or the factorized chain.
        ``phase`` is accepted for interface uniformity: a lookup has one
        realization, so no plan is consulted."""
        if "w" in params:
            w = params["w"] if dtype is None else params["w"].to(dtype)
            return w[ids.long()]
        return mpo.embed_lookup(self._prepare_cores(params, dtype), ids)

    def cache_weights(self, params, *, dtype=None):
        """One-time densification at serving init (next to the KV cache).

        Returns a new params tree where every factorized matrix whose decode
        plan is ``cached`` is replaced by its contracted dense ``{"w": W}``;
        everything else passes through untouched.  Scan-stacked leading
        layer dims are contracted layer by layer.  The result is a SNAPSHOT:
        re-run after any core mutation."""
        if not isinstance(params, dict):
            return params
        if "cores" in params:
            cores = layers.cores_to_list(params["cores"])
            shapes = tuple(tuple(c.shape[-4:]) for c in cores)
            if self.plan(shapes, 1, "decode").mode != "cached":
                return params
            w = _reconstruct_stacked(cores)
            return {"w": w if dtype is None else w.to(dtype)}
        return {k: self.cache_weights(v, dtype=dtype) for k, v in params.items()}


def _reconstruct_stacked(cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """``mpo.reconstruct`` over any leading stacked dims (scanned layers),
    one matrix at a time."""
    if cores[0].dim() == 4:
        return mpo.reconstruct(list(cores))
    return torch.stack([_reconstruct_stacked([c[i] for c in cores])
                        for i in range(cores[0].shape[0])])


@functools.lru_cache(maxsize=None)
def engine_for(cfg) -> MPOEngine:
    """Shared engine instance per (hashable, frozen) ``MPOConfig``."""
    return MPOEngine(cfg)
