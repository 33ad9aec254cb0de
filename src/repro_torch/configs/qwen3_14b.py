"""qwen3-14b [dense; hf:Qwen/Qwen3-14B]."""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.layers import MPOConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    mlp_act="silu",
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=False,
    parallelism="sp",
    mpo=MPOConfig(enabled=True, n=5, bond_embed=64, bond_attn=128,
                  bond_ffn=128, mode="auto", shard_multiple=16),
)
