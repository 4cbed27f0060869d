"""Kimi K2 — trillion-parameter MoE, 384 experts top-8, 32B active
(paper-table numbers) [arXiv:2501.kimi2]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,                      # per-expert ffn (fine-grained experts)
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    moe_every=1, moe_offset=0,
    rope_theta=5e4,
    fsdp=True,
    chunked_ce=512,                 # 163k vocab: never materialize full logits
    source="arXiv:2501.kimi2",
))
