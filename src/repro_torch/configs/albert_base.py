"""albert-base (paper subject) [Lan et al. 2020]."""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.layers import MPOConfig

CONFIG = ModelConfig(
    name="albert-base",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=30000,
    mlp_act="gelu_plain",
    causal=False,
    share_layers=True,   # ALBERT cross-layer parameter sharing
    num_classes=2,
    tie_embeddings=True,
    mpo=MPOConfig(enabled=True, n=5, bond_embed=40, bond_attn=64,
                  bond_ffn=64, mode="auto", shard_multiple=1),
)
