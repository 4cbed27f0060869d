"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

`stage.encode_bucket` replaces the JAX package's Pallas `encode_bucket`.
Kernels build on first use (`kernels.build`), never at import.
"""
