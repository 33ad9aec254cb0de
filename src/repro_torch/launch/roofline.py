"""Roofline terms from dry-run counts, on the NVIDIA H100 — the port of
``repro.launch.roofline`` (whose model is a TPU's).

compute_s    = matmul FLOPs per rank    / peak FLOP/s of the step's dtype
memory_s     = matmul bytes per rank    / HBM bandwidth
collective_s = collective bytes per rank / NVLink bandwidth (one direction)

The counts are per rank (``launch.op_analysis``), so each term divides by
one card's peak.  The step time the roofline predicts is the largest term:
a floor, which a measured step time at or above it bears out.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM (80 GB HBM3), one card: dense bf16 tensor-core and f32
# (non-tensor-core) peaks, HBM3 bandwidth, and NVLink 4's 900 GB/s as 450
# GB/s each way (the figures PERF.md's kernel bounds use)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12               # B/s
NVLINK_BW = 450e9              # B/s, one direction


def active_param_count(cfg) -> int:
    """Active parameters of ``cfg``'s model (MoE: only top_k of the experts
    count), from its init on the ``meta`` device (nothing drawn)."""
    import torch

    from repro_torch.models.model import family_module

    def count(tree, experts=False):
        if isinstance(tree, dict):
            return sum(count(v, experts or k == "experts") for k, v in tree.items())
        n = math.prod(tree.shape)
        if experts and cfg.num_experts:
            n = n * cfg.top_k / cfg.num_experts
        return n

    with torch.device("meta"):
        tree = family_module(cfg).init(torch.Generator(), cfg)
    return int(count(tree))


def roofline(rec: dict) -> dict:
    """``rec`` (a dry-run record: ``flops_per_device``, ``bytes_per_device``,
    ``collective_bytes`` {kind: bytes}, ``devices``, ``dtype``, optionally
    ``model_flops`` / ``model_flops_dense``) with the three terms (seconds),
    the dominant one, the predicted ``step_s``, and the useful-FLOP
    fractions."""
    chips = rec["devices"]
    peak = PEAK_FLOPS[rec.get("dtype", "bfloat16")]
    flops_pd = rec["flops_per_device"]
    coll_pd = sum(rec["collective_bytes"].values())
    terms = {"compute_s": flops_pd / peak,
             "memory_s": rec["bytes_per_device"] / HBM_BW,
             "collective_s": coll_pd / NVLINK_BW}
    dominant = max(terms, key=terms.get)
    step_s = max(terms.values())
    useful = rec.get("model_flops", 0.0)
    useful_dense = rec.get("model_flops_dense", useful)
    flops_total = flops_pd * chips
    mfu = (useful / (chips * peak)) / step_s if step_s else 0.0
    mfu_dense = (useful_dense / (chips * peak)) / step_s if step_s else 0.0
    return dict(
        rec,
        **terms,
        dominant=dominant,
        step_s=step_s,
        # the fraction of counted FLOPs that are the MPO model's own
        # (6 N D): catches recomputation and dense-reconstruct overhead
        useful_flops_ratio=(useful / flops_total) if flops_total else 0.0,
        roofline_fraction=min(mfu, 1.0),
        roofline_fraction_dense_equiv=min(mfu_dense, 1.0),
    )
