"""phi3.5-moe-42b-a6.6b [moe; hf:microsoft/Phi-3.5-MoE-instruct; hf]."""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.layers import MPOConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    top_k=2,
    mlp_act="silu",
    tie_embeddings=False,
    mpo=MPOConfig(enabled=True, n=5, bond_embed=64, bond_attn=128,
                  bond_ffn=128, mode="auto", shard_multiple=16),
)
