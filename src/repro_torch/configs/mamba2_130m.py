"""Mamba2-130M — attention-free SSM, SSD (state-space duality)
[arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                         # mamba blocks have no separate MLP
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=True,
    source="arXiv:2405.21060",
))
