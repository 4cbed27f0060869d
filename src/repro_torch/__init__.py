"""repro_torch — REFT on PyTorch and CUDA (NVIDIA Hopper).

The port of the JAX reference package `repro`, module for module
(`core/`, `kernels/`, `api/`, `models/`, ...).  It imports `torch`, never
`jax`, and nothing of `repro`.  Package `__init__`s import nothing heavy:
the snapshot-manager processes start with `spawn`, import
`repro_torch.core.smp` again, and stay numpy-only.

Entry point: `python -m repro_torch.launch.train` (CUDA by default).
"""
