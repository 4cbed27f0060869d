"""HuBERT-XLarge — encoder-only audio backbone [arXiv:2106.07447].

Modality carve-out: the conv/mel frontend is a stub — ``input_specs`` provides
precomputed frame embeddings (B, S, d_model); we build the transformer encoder
that consumes them, with a masked-prediction head over the 504-unit codebook.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,                 # k-means codebook units
    is_encoder=True,
    causal=False,
    embed_inputs=False,             # frame embeddings come from the stub frontend
    source="arXiv:2106.07447",
))
