"""llava-next-34b [vlm; hf:llava-hf/llava-v1.6; unverified]."""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.layers import MPOConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    mlp_act="silu",
    frontend_len=1024,   # anyres patch tokens (stub embeddings)
    frontend_dim=1152,   # SigLIP-like patch embedding dim
    tie_embeddings=False,
    parallelism="sp",
    mpo=MPOConfig(enabled=True, n=5, bond_embed=64, bond_attn=128,
                  bond_ffn=128, mode="auto", shard_multiple=16),
)
