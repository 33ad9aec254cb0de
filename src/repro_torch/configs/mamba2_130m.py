"""mamba2-130m [ssm; arXiv:2405.21060]."""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.layers import MPOConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=12,        # unused (attention-free)
    num_kv_heads=12,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    subquadratic=True,
    tie_embeddings=True,
    mpo=MPOConfig(enabled=True, n=5, bond_embed=48, bond_attn=64,
                  bond_ffn=64, mode="auto", shard_multiple=16),
)
