"""DeepSeek 67B — dense llama-arch, 95 layers, GQA(kv=8) [arXiv:2401.02954]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=1e4,
    fsdp=True,
    chunked_ce=512,
    source="arXiv:2401.02954",
))
