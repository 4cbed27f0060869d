"""OPT family — the paper's own evaluation models (§6.1) [arXiv:2205.01068].

Used by the REFT benchmarks (weak/strong scaling over OPT-125M..2.7B).
"""
from repro_torch.configs.base import ModelConfig, register

_COMMON = dict(family="dense", vocab_size=50272, rope_theta=1e4,
               source="arXiv:2205.01068 (paper §6.1)")

OPT_125M = register(ModelConfig(
    name="opt-125m", num_layers=12, d_model=768, num_heads=12,
    num_kv_heads=12, d_ff=3072, **_COMMON))

OPT_350M = register(ModelConfig(
    name="opt-350m", num_layers=24, d_model=1024, num_heads=16,
    num_kv_heads=16, d_ff=4096, **_COMMON))

OPT_1_3B = register(ModelConfig(
    name="opt-1.3b", num_layers=24, d_model=2048, num_heads=32,
    num_kv_heads=32, d_ff=8192, **_COMMON))

OPT_2_7B = register(ModelConfig(
    name="opt-2.7b", num_layers=32, d_model=2560, num_heads=32,
    num_kv_heads=32, d_ff=10240, **_COMMON))
