"""RAIM5 XOR parity: plain version and CUDA kernel.

Replaces the TPU kernel `repro/kernels/xor_parity.py::xor_reduce` (Pallas
`_xor_kernel`) with a hand-written CUDA kernel for Hopper
(`csrc/xor_parity.cu`, built for sm_90a by `kernels.build`).

encode: parity[t] = XOR_i blocks[i, t]      blocks: (k, n) uint32
decode: missing   = XOR(survivors, parity)  == encode on (k, n) stacked

Any n is taken, as the reference's padding takes it: rows whose lanes
allow 16-byte vectors (n % 4 == 0) go through the kernel's vector body,
others through its 4-byte body (`vector_count`).

`xor_reduce` dispatches on the input's device: a CPU tensor runs
`xor_reduce_plain`; a CUDA tensor launches the kernel or raises; any
other device raises.
"""
from __future__ import annotations

import ctypes

import torch

# threads per block of the CUDA kernel (must equal XOR_THREADS in
# csrc/xor_parity.cu) and resident blocks per SM the grid aims for
XOR_THREADS = 256
BLOCKS_PER_SM = 8


def _check(blocks) -> None:
    if not isinstance(blocks, torch.Tensor):
        raise TypeError(f"blocks must be a torch.Tensor, got {type(blocks)}")
    if blocks.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"blocks must be uint32 (or int32 viewed as "
                        f"uint32), got {blocks.dtype}")
    if blocks.dim() != 2 or blocks.shape[0] < 1 or blocks.shape[1] < 1:
        raise ValueError(f"blocks must be (k, n) with k, n >= 1, got "
                         f"{tuple(blocks.shape)}")
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")


def xor_reduce_plain(blocks: torch.Tensor) -> torch.Tensor:
    """Plain version (any device): XOR of the int32 view, row by row."""
    _check(blocks)
    rows = blocks.view(torch.int32)
    acc = rows[0].clone()
    for i in range(1, rows.shape[0]):
        acc ^= rows[i]
    return acc.view(blocks.dtype)


def vector_count(n: int, data_ptr: int) -> int:
    """16-byte vectors per row the kernel's vector body takes: every row
    must start 16-byte aligned, so n % 4 == 0 and an aligned base; else 0
    and the 4-byte body takes the whole row."""
    return n // 4 if n % 4 == 0 and data_ptr % 16 == 0 else 0


def grid_size(n: int, n_vec: int, sm_count: int) -> int:
    """Blocks of the grid-stride launch: enough for one item per thread,
    at most BLOCKS_PER_SM per SM."""
    items = max(n_vec, n - 4 * n_vec)
    return max(1, min(-(-items // XOR_THREADS), BLOCKS_PER_SM * sm_count))


def _lib():
    from repro_torch.kernels.build import library
    return library("xor_parity", _SIGNATURES)


def xor_reduce(blocks: torch.Tensor) -> torch.Tensor:
    """XOR-reduce along axis 0: (k, n) uint32 -> (n,) in blocks' dtype.

    CUDA tensors launch `csrc/xor_parity.cu` on the current stream (bound:
    (k+1) * 4 * n bytes at 3.35 TB/s on an H100 SXM); CPU tensors run
    `xor_reduce_plain`."""
    _check(blocks)
    if blocks.device.type == "cpu":
        return xor_reduce_plain(blocks)
    if blocks.device.type != "cuda":
        raise ValueError(f"xor_reduce runs on cuda or cpu tensors, not "
                         f"{blocks.device}")
    k, n = blocks.shape
    out = torch.empty(n, dtype=blocks.dtype, device=blocks.device)
    n_vec = vector_count(n, blocks.data_ptr())
    sms = torch.cuda.get_device_properties(blocks.device).multi_processor_count
    lib = _lib()
    rc = lib.reft_xor_reduce(
        blocks.data_ptr(), k, n, n_vec, out.data_ptr(),
        grid_size(n, n_vec, sms), blocks.device.index or 0,
        torch.cuda.current_stream(blocks.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"xor_reduce launch failed: "
                           f"{lib.reft_xor_error_string(rc).decode()}")
    xor_reduce.launches += 1
    return out


xor_reduce.launches = 0        # kernel launches (not plain-version calls)

_SIGNATURES = {
    # blocks, k, n, n_vec, out, grid, device, stream
    "reft_xor_reduce": ([
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int),
    "reft_xor_error_string": ([ctypes.c_int], ctypes.c_char_p),
}
