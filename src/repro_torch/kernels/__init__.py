"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

`stage.encode_bucket` replaces the JAX package's Pallas `encode_bucket`;
`ssd_scan.ssd_scan_fwd` its Pallas `ssd_scan`, and `ssd_scan.ssd_scan_bwd`
computes that scan's gradient; `swa_attention.swa_flash_fwd` replaces its
Pallas `swa_flash`, and `swa_attention.swa_flash_bwd` computes that
attention's gradient. Kernels build on first use (`kernels.build`), never
at import.
"""


def _wrappers():
    from repro_torch.kernels import ssd_scan, stage, swa_attention
    return {"encode_bucket": stage.encode_bucket,
            "ssd_scan": ssd_scan.ssd_scan_fwd,
            "ssd_scan_bwd": ssd_scan.ssd_scan_bwd,
            "swa_flash": swa_attention.swa_flash_fwd,
            "swa_flash_bwd": swa_attention.swa_flash_bwd}


def launch_counts() -> dict:
    """Kernel name -> launches so far (plain-version calls not counted)."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
