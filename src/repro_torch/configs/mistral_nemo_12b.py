"""mistral-nemo-12b [dense; hf:mistralai/Mistral-Nemo-Base-2407; hf]."""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.layers import MPOConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    mlp_act="silu",
    rope_theta=1000000.0,
    tie_embeddings=False,
    mpo=MPOConfig(enabled=True, n=5, bond_embed=64, bond_attn=128,
                  bond_ffn=128, mode="auto", shard_multiple=16),
)
