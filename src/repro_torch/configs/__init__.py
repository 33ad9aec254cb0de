"""Config registry: ``get_config(name)`` for the architectures the port serves."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig, scaled_down

# arch id -> module name; the other architectures of the reference come with
# their families (ROADMAP.md, Queue 1 item 7)
ARCHS = {
    "qwen3-14b": "qwen3_14b",
    "bert-base": "bert_base",
    "mamba2-130m": "mamba2_130m",
}


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch {name!r}; the port "
                       f"has {sorted(ARCHS)}")
    cfg = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}").CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def smoke_config(name: str, **overrides) -> ModelConfig:
    return scaled_down(get_config(name), **overrides)
