"""Config registry: ``get_config(name)`` for every architecture of the reference."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, scaled_down

# arch id -> module name, under the reference's ids: every one of its archs
ARCHS = {
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b_a66b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "llava-next-34b": "llava_next_34b",
    "zamba2-7b": "zamba2_7b",
    "whisper-tiny": "whisper_tiny",
    "gemma2-27b": "gemma2_27b",
    "nemotron-4-15b": "nemotron4_15b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "qwen3-14b": "qwen3_14b",
    "mamba2-130m": "mamba2_130m",
    # the paper's own subjects
    "albert-base": "albert_base",
    "bert-base": "bert_base",
}


# the dry run's assigned architectures: all but the paper's own subjects
ASSIGNED = [a for a in ARCHS if a not in ("albert-base", "bert-base")]


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(ARCHS)}")
    cfg = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}").CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def smoke_config(name: str, **overrides) -> ModelConfig:
    return scaled_down(get_config(name), **overrides)


def cells(include_skipped: bool = False):
    """All assigned (arch, shape name, skip) dry-run cells, as the
    reference's: ``long_500k`` needs sub-quadratic attention, so only the
    SSM and hybrid archs run it (the others are yielded with skip=True
    when asked)."""
    for arch in ASSIGNED:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            skip = shape.name == "long_500k" and not cfg.subquadratic
            if skip and not include_skipped:
                continue
            yield arch, shape.name, skip
