"""Jamba-v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer [arXiv:2403.19887]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2, moe_offset=1,      # MoE on every other layer
    attn_period=8, attn_index=4,    # 1 attention : 7 mamba per 8-layer period
    ssm_state=16,                   # jamba uses mamba-1 state 16
    ssm_head_dim=64,
    fsdp=True,
    source="arXiv:2403.19887",
))
