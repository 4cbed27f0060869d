"""Qwen3-8B — dense, GQA(kv=8), qk-norm [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    head_dim=128,
    rope_theta=1e6,
    chunked_ce=512,
    source="hf:Qwen/Qwen3-8B",
))
