"""Phi-3-vision 4.2B — phi3-mini decoder + CLIP frontend (stubbed)
[hf:microsoft/Phi-3-vision-128k-instruct].

Modality carve-out: ``input_specs`` provides precomputed patch embeddings
(B, num_patches, d_model) prepended to the token sequence.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,                # MHA
    d_ff=8192,
    vocab_size=32064,
    num_patches=576,                # CLIP ViT-L/14 @ 336px
    rope_theta=1e4,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
))
