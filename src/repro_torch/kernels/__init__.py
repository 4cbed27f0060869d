"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

`xor_parity.xor_reduce` replaces the JAX package's Pallas `xor_reduce`
(RAIM5 parity encode and decode); `stage.encode_bucket` its Pallas
`encode_bucket`; `ssd_scan.ssd_scan_fwd` its Pallas `ssd_scan`, and
`ssd_scan.ssd_scan_bwd` computes that scan's gradient;
`swa_attention.swa_flash_fwd` replaces its Pallas `swa_flash`, and
`swa_attention.swa_flash_bwd` computes that attention's gradient.
`ops` holds the public wrappers exported here, `ref` an oracle for each.
Kernels build on first use (`kernels.build`), never at import.
"""
from repro_torch.kernels.ops import (
    encode_bucket, ssd_scan, swa_attention, xor_parity_decode,
    xor_parity_encode,
)
from repro_torch.kernels.stage import bucket_crc

__all__ = ["bucket_crc", "encode_bucket", "launch_counts",
           "reset_launch_counts", "ssd_scan", "swa_attention",
           "xor_parity_decode", "xor_parity_encode"]


def _wrappers():
    # `ssd_scan` and `swa_attention` here name the public functions (as in
    # the reference), so the submodules are reached by their full names
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd, ssd_scan_fwd
    from repro_torch.kernels.stage import encode_bucket as _encode_bucket
    from repro_torch.kernels.swa_attention import (swa_flash_bwd,
                                                   swa_flash_fwd)
    from repro_torch.kernels.xor_parity import xor_reduce
    return {"encode_bucket": _encode_bucket,
            "ssd_scan": ssd_scan_fwd,
            "ssd_scan_bwd": ssd_scan_bwd,
            "swa_flash": swa_flash_fwd,
            "swa_flash_bwd": swa_flash_bwd,
            "xor_reduce": xor_reduce}


def launch_counts() -> dict:
    """Kernel name -> launches so far (plain-version calls not counted)."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
    from repro_torch.kernels.stage import encode_bucket
    encode_bucket.fold_crc_launches = 0
