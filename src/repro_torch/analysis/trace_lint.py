"""Trace-hazard linter — the port of ``repro.analysis.trace_lint``: prefill,
decode and the train loss run once each on fake tensors.

The reference traces its steps to jaxprs.  Eager torch has no trace; the
port runs each step once under ``torch._subclasses.fake_tensor.
FakeTensorMode`` on the CPU device, at the real config's widths and dtypes
and a short sequence (``trace_shapes``): fake tensors carry shapes, dtypes
and devices and allocate nothing, and fake CPU tensors take the kernels'
plain versions through the wrappers' ``device.type == "cpu"`` branch (no
wrapper has a fake or meta branch; a CUDA tensor still launches or raises).
The depth is cut to ``TRACE_LAYERS`` layers (a hybrid model to one segment
of ``attn_every``) and an expert stack to ``TRACE_EXPERTS`` experts: each
hazard is a property of a layer's (an expert's) code, which every layer of
a stack (every expert) runs.  A ``TorchDispatchMode``
(``HostTransferMode``) watches every op of a step.

Checks, per config:

``trace/cache-drift``     the decode step must be a fixed point of its
                          cache: every cache leaf's shape, dtype and device
                          equal going in and coming out (error).
``trace/host-transfer``   host syncs and copies inside a step: reads of a
                          value to the host (``aten._local_scalar_dense``:
                          ``.item()``, ``.tolist()``, a tensor used as a
                          Python bool; ``aten.equal``), ops whose output
                          shape waits on the data (``nonzero``,
                          ``masked_select``, ``unique``) and copies across
                          devices (``_to_copy`` / ``copy_``) (warning).
``trace/phase-drift``     prefill and decode logits disagree on dtype
                          (warning).
``trace/ops``             in place of the reference's ``trace/hlo``: the
                          decode step's most frequent aten ops (info).

Not ported, having no meaning in eager torch: ``trace/weak-type`` (torch
has no weak-typed outputs: a step's output dtype is what it computes) and
``trace/closure-constant`` (nothing is baked into a trace: tensors a step
closes over are read anew each call).
"""

from __future__ import annotations

import collections
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding
from repro_torch.configs.base import ShapeConfig

MODEL_FILE = "src/repro_torch/models/model.py"
TRACE_LAYERS = 2       # layers a traced stack keeps (encoder and decoder each)
TRACE_EXPERTS = 4      # experts a traced MoE layer keeps (top_k stays within them)

aten = torch.ops.aten
SYNC_OPS = {aten._local_scalar_dense.default, aten.equal.default}
DYNAMIC_OPS = {aten.nonzero.default, aten.masked_select.default, aten._unique2.default,
               aten.unique_dim.default, aten.unique_consecutive.default}
# not ops a step runs: metadata queries
_NOT_OPS = {"prim.device.default"}


def trace_shapes(cfg) -> dict:
    """Per-config trace shapes: vlm sequences must cover the patch-token
    prefix (``frontend_len``) plus some text."""
    seq = 64
    if cfg.family == "vlm":
        seq += cfg.frontend_len
    return {
        "train": ShapeConfig("lint_train", "train", seq, 2),
        "prefill": ShapeConfig("lint_prefill", "prefill", seq, 2),
        "decode": ShapeConfig("lint_decode", "decode", seq + 64, 2),
    }


def trace_config(cfg):
    """``cfg`` at ``TRACE_LAYERS`` layers (each stack; a hybrid stack one
    segment) and ``TRACE_EXPERTS`` experts, widths unchanged."""
    kw = {"num_layers": (cfg.attn_every if cfg.family == "hybrid"
                         else min(cfg.num_layers, TRACE_LAYERS))}
    if cfg.num_experts:
        kw["num_experts"] = min(cfg.num_experts, TRACE_EXPERTS)
        kw["top_k"] = min(cfg.top_k, kw["num_experts"])
    if cfg.num_enc_layers:
        kw["num_enc_layers"] = min(cfg.num_enc_layers, TRACE_LAYERS)
    return dataclasses.replace(cfg, **kw)


def _scalar(t):
    """A stand-in value for reading a fake tensor on the host."""
    if t.dtype == torch.bool:
        return False
    return 0 if not (t.dtype.is_floating_point or t.dtype.is_complex) else 0.0


class HostTransferMode(TorchDispatchMode):
    """Counts, over the ops dispatched inside it: ``syncs`` (reads of a
    device value on the host, and ops whose output shape waits on the data),
    ``copies`` (copies across devices) and every op (``ops``).  On fake
    tensors a host read returns a stand-in (0 / False) and a data-dependent
    shape an empty result, so the step runs on to its end."""

    def __init__(self):
        super().__init__()
        self.syncs: collections.Counter = collections.Counter()
        self.copies: collections.Counter = collections.Counter()
        self.ops: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        kwargs = kwargs or {}
        name = str(func)
        self.ops[name] += 1
        if func in SYNC_OPS or func in DYNAMIC_OPS:
            self.syncs[name] += 1
            t = args[0]
            if isinstance(t, FakeTensor):
                if func is aten._local_scalar_dense.default:
                    return _scalar(t)
                if func is aten.equal.default:
                    return False
                if func is aten.nonzero.default:
                    return torch.empty((0, t.dim()), dtype=torch.long, device=t.device)
                out = torch.empty((0,), dtype=t.dtype, device=t.device)
                return out if func is aten.masked_select.default else (
                    out, *(torch.empty((0,), dtype=torch.long, device=t.device)
                           for _ in range(2)))
        elif func is aten._to_copy.default:
            dst = kwargs.get("device")
            if dst is not None and torch.device(dst).type != args[0].device.type:
                self.copies[f"{name} {args[0].device.type}->{torch.device(dst).type}"] += 1
        elif func is aten.copy_.default:
            if args[0].device.type != args[1].device.type:
                self.copies[f"{name} {args[1].device.type}->{args[0].device.type}"] += 1
        return func(*args, **kwargs)

    def transfers(self) -> dict:
        """``{"syncs": n, "copies": n}``."""
        return {"syncs": sum(self.syncs.values()), "copies": sum(self.copies.values())}

    def top_ops(self, k: int = 5) -> list:
        return [(n, c) for n, c in self.ops.most_common() if n not in _NOT_OPS][:k]


def host_transfer_findings(mode: HostTransferMode, *, config: str, phase: str) -> list:
    """The ``trace/host-transfer`` finding of one step's counts."""
    if not mode.syncs and not mode.copies:
        return []
    what = ", ".join(f"{n} x{c}" for n, c in sorted((mode.syncs + mode.copies).items()))
    return [Finding(check="trace/host-transfer", severity="warning", file=MODEL_FILE,
                    location=f"{phase}:step",
                    message=f"{sum(mode.syncs.values())} host sync(s) and "
                            f"{sum(mode.copies.values())} cross-device copy(ies) inside the "
                            f"step ({what}) — the host waits on the card in a hot loop",
                    config=config)]


def run_step(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), HostTransferMode)``: one step under the
    counting mode (fake or real tensors alike)."""
    mode = HostTransferMode()
    with mode:
        out = fn(*args, **kwargs)
    return out, mode


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1] if prefix else "": tree}


def cache_specs(cache) -> dict:
    """A cache tree's leaves as ``{path: (shape, dtype, device type)}``."""
    return {k: (tuple(v.shape), v.dtype, v.device.type) for k, v in _flat(cache).items()}


def cache_drift_findings(ins: dict, outs: dict, *, config: str, phase: str = "decode") -> list:
    """The fixed-point precondition, leaf by leaf, over the ``cache_specs``
    of the cache going in and coming out (public for seeding tests)."""
    findings = []
    for path in sorted(set(ins) | set(outs)):
        a, b = ins.get(path), outs.get(path)
        loc = f"{phase}:cache/{path}" if path else f"{phase}:cache"
        if a is None or b is None:
            findings.append(Finding(
                check="trace/cache-drift", severity="error", file=MODEL_FILE, location=loc,
                message="cache leaf appears on only one side of the step — the loop state "
                        "is not a fixed point", config=config))
        elif a != b:
            findings.append(Finding(
                check="trace/cache-drift", severity="error", file=MODEL_FILE, location=loc,
                message=f"cache leaf drifts across the step: {a[0]}/{a[1]}/{a[2]} -> "
                        f"{b[0]}/{b[1]}/{b[2]} — the next step sees another cache",
                config=config))
    return findings


def _inputs(cfg, shape: ShapeConfig, *, labels: bool = False) -> dict:
    """A batch of zeros at ``shape``: tokens (and labels), and the family's
    frontend input (``data.pipeline.frontend_input``)."""
    from repro_torch.data.pipeline import frontend_input
    b = shape.global_batch
    text = shape.seq_len - (cfg.frontend_len if cfg.family == "vlm" else 0)
    out = {"tokens": torch.zeros((b, text), dtype=torch.int32)}
    if labels:
        out["labels"] = torch.zeros((b, shape.seq_len if cfg.family == "vlm" else text),
                                    dtype=torch.int32)
    frontend = frontend_input(cfg)
    if frontend is not None:
        out[frontend[0]] = torch.zeros((b, cfg.frontend_len, frontend[1]))
    return out


def decode_transfers(cfg, *, weight_cache: bool = True, paged: bool = False,
                     batch: int = 2, prompt: int = 64, max_len: int = 128) -> dict:
    """``{"syncs", "copies"}`` of one decode step of ``cfg``'s serving
    path (``make_serve_steps(weight_cache=, paged=)``) on fake CPU tensors,
    after a prefill of ``prompt`` tokens: what ``trace/host-transfer``
    reports for that step."""
    return _trace_serving(cfg, weight_cache=weight_cache, paged=paged, batch=batch,
                          prompt=prompt, max_len=max_len)["decode_mode"].transfers()


def _trace_serving(cfg, *, weight_cache: bool, paged: bool, batch: int, prompt: int,
                   max_len: int) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.model import build
    from repro_torch.train.steps import make_serve_steps
    shape = ShapeConfig("lint_prefill", "prefill", prompt, batch)
    with FakeTensorMode(), torch.no_grad():
        model = build(cfg, device="cpu")
        prefill, decode, init_serve, _ = make_serve_steps(
            model, weight_cache=weight_cache,
            paged=paged and cfg.family in ("dense", "moe", "vlm"))
        sparams, cache = init_serve(model.tree(), batch, max_len)
        (plogits, cache), pmode = run_step(prefill, sparams, _inputs(cfg, shape), cache)
        before = cache_specs(cache)
        tokens = torch.zeros((batch, 1), dtype=torch.int32)
        (_, dlogits, cache), dmode = run_step(decode, sparams, tokens, cache)
        return {"prefill_logits": plogits.dtype, "decode_logits": dlogits.dtype,
                "prefill_mode": pmode, "decode_mode": dmode, "cache_in": before,
                "cache_out": cache_specs(cache), "model": model}


def _trace_train(cfg, shape: ShapeConfig) -> HostTransferMode:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.lightweight import leaves
    from repro_torch.models.model import build, differentiable
    from repro_torch.train.steps import lm_loss
    if cfg.loss_chunk and shape.seq_len % cfg.loss_chunk:
        cfg = dataclasses.replace(cfg, loss_chunk=0)
    with FakeTensorMode():
        model = build(cfg, device="cpu")
        params = model.tree()
        flat = list(leaves(params))
        batch = _inputs(cfg, shape, labels=True)

        def step():
            with differentiable(flat):
                loss, _ = lm_loss(model, params, batch)
                return torch.autograd.grad(loss, flat, allow_unused=True)

        _, mode = run_step(step)
    return mode


def lint_traces(cfg) -> list:
    """Prefill, decode (the weight-cached serving path) and the train
    loss's forward and backward, once each at ``trace_config(cfg)``, with
    every check."""
    tcfg = trace_config(cfg)
    shapes = trace_shapes(tcfg)
    findings = []
    res = _trace_serving(tcfg, weight_cache=True, paged=False,
                         batch=shapes["decode"].global_batch,
                         prompt=shapes["prefill"].seq_len, max_len=shapes["decode"].seq_len)
    findings += cache_drift_findings(res["cache_in"], res["cache_out"], config=cfg.name)
    for phase in ("prefill", "decode"):
        findings += host_transfer_findings(res[f"{phase}_mode"], config=cfg.name, phase=phase)
    findings += host_transfer_findings(_trace_train(tcfg, shapes["train"]),
                                       config=cfg.name, phase="train")
    findings += phase_drift_findings(res["prefill_logits"], res["decode_logits"],
                                     config=cfg.name)
    hot = res["decode_mode"].top_ops()
    findings.append(Finding(check="trace/ops", severity="info", file=MODEL_FILE,
                            location="decode:ops",
                            message="top ops: " + ", ".join(f"{n} x{c}" for n, c in hot),
                            config=cfg.name))
    return findings


def phase_drift_findings(prefill_dtype, decode_dtype, *, config: str) -> list:
    """``trace/phase-drift`` where prefill's and decode's logits dtypes
    differ (public for seeding tests)."""
    if prefill_dtype == decode_dtype:
        return []
    return [Finding(check="trace/phase-drift", severity="warning", file=MODEL_FILE,
                    location="prefill-vs-decode:logits",
                    message=f"logits dtype differs between phases: prefill={prefill_dtype} "
                            f"decode={decode_dtype}", config=config)]
