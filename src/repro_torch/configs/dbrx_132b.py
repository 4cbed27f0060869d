"""DBRX 132B — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    experts_per_token=4,
    moe_every=1, moe_offset=0,      # every layer is MoE
    rope_theta=5e5,
    fsdp=True,
    source="hf:databricks/dbrx-base",
))
