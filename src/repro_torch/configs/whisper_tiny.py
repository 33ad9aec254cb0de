"""whisper-tiny [audio; arXiv:2212.04356; unverified]."""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.layers import MPOConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,
    num_enc_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    frontend_len=1500,   # mel-frame embeddings (the conv frontend stubbed)
    frontend_dim=384,
    max_pos=32768,       # the reference extends it for its 32k decode cell
    tie_embeddings=True,
    mpo=MPOConfig(enabled=True, n=5, bond_embed=48, bond_attn=64,
                  bond_ffn=64, mode="auto", shard_multiple=16),
)
