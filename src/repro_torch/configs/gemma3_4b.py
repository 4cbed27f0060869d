"""Gemma3-4B — dense, 5:1 local:global interleave, 128k context
[hf:google/gemma-3-1b-pt]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    sliding_window=1024,
    global_every=6,                 # 5 local : 1 global
    qk_norm=True,
    head_dim=256,
    rope_theta=1e6,
    chunked_ce=512,                 # 262k vocab
    window_kv_cache=False,          # flipped on in the §Perf hillclimb
    source="hf:google/gemma-3-1b-pt",
))
