from repro_torch.configs.base import (
    ModelConfig, InputShape, INPUT_SHAPES, get_config, list_configs,
    register, shape_supported,
)

ASSIGNED_ARCHS = (
    "starcoder2-3b", "hubert-xlarge", "jamba-v0.1-52b", "phi-3-vision-4.2b",
    "dbrx-132b", "kimi-k2-1t-a32b", "qwen3-8b", "mamba2-130m",
    "deepseek-67b", "gemma3-4b",
)

__all__ = [
    "ModelConfig", "InputShape", "INPUT_SHAPES", "get_config", "list_configs",
    "register", "shape_supported", "ASSIGNED_ARCHS",
]
