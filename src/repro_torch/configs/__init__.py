"""Config registry: ``get_config(name)`` for every architecture of the reference."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig, scaled_down

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


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(ARCHS)}")
    cfg = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}").CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def smoke_config(name: str, **overrides) -> ModelConfig:
    return scaled_down(get_config(name), **overrides)
