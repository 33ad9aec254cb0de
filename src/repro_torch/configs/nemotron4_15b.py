"""nemotron-4-15b [dense; arXiv:2402.16819; unverified]."""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.layers import MPOConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    mlp_act="relu2",
    tie_embeddings=False,
    mpo=MPOConfig(enabled=True, n=5, bond_embed=64, bond_attn=128,
                  bond_ffn=128, mode="auto", shard_multiple=16),
)
