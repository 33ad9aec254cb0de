"""Model configuration dataclass (the port's copy of ``repro.configs.base``)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.layers import MPOConfig


def pad_to(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture's full description (family, dims, MPO policy).

    Usually obtained from the registry rather than built by hand::

        cfg = configs.get_config("bert-base")          # full scale
        cfg = configs.smoke_config("qwen3-14b")        # CPU-sized analog
    """

    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # ---- transformer variants ----
    mlp_act: str = "silu"            # silu | gelu | relu2 | gelu_plain
    qk_norm: bool = False
    logit_softcap: float | None = None
    attn_softcap: float | None = None
    local_window: int | None = None  # alternating local/global when set
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    # ---- MoE ----
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # ---- SSM (Mamba2) ----
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    attn_every: int = 0
    num_shared_attn: int = 2
    # ---- enc-dec / multimodal stubs ----
    num_enc_layers: int = 0
    frontend_len: int = 0
    frontend_dim: int = 0
    max_pos: int = 4096
    # ---- encoder-classification (paper's ALBERT/BERT subjects) ----
    causal: bool = True
    share_layers: bool = False       # ALBERT cross-layer sharing
    num_classes: int = 0             # >0 adds a classifier head
    parallelism: str = "tp"
    # ---- parameterization ----
    mpo: MPOConfig = MPOConfig()
    dtype: str = "bfloat16"
    remat: bool = True
    loss_chunk: int = 0
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        # vocab padded to a multiple of 256, as the reference pads it
        object.__setattr__(self, "vocab_size", pad_to(self.vocab_size, 256))

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}[self.dtype]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One workload point: what shape of batch hits the model, and in which
    phase.  E.g. ``ShapeConfig("serve", "prefill", seq_len=32,
    global_batch=8)`` describes prefilling 8 prompts of 32 tokens."""

    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


# the dry run's workload points (the reference's)
SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def scaled_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    small = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        mpo=dataclasses.replace(cfg.mpo, bond_embed=8, bond_attn=8,
                                bond_ffn=8, shard_multiple=1),
        remat=False,
        dtype="float32",
    )
    if cfg.num_experts:
        small.update(num_experts=4, top_k=min(cfg.top_k, 2))
    if cfg.ssm_state:
        small.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.attn_every:
        small.update(num_layers=4, attn_every=2)
    if cfg.num_enc_layers:
        small.update(num_enc_layers=2)
    if cfg.frontend_len:
        small.update(frontend_len=8, frontend_dim=24)
    if cfg.family == "encdec":
        small.update(max_pos=512)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
