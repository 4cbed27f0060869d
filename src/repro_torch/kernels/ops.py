"""Public wrappers around the port's kernels (the counterpart of
`repro/kernels/ops.py`, with the reference's signatures minus
`interpret`: a CPU tensor runs a kernel's plain version, a CUDA tensor
launches the kernel).  Each has an oracle in `ref.py`."""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_scan_kernel
from repro_torch.kernels.stage import encode_bucket as _encode_bucket_kernel
from repro_torch.kernels.swa_attention import swa_flash as _swa_flash_kernel
from repro_torch.kernels.xor_parity import xor_reduce as _xor_reduce_kernel

PAD_BYTES = 512                # 128 uint32 lanes x 4 bytes


def xor_parity_encode(blocks):
    """XOR parity of k byte blocks. blocks: (k, nbytes) uint8 -> (nbytes,).

    Pads each row to a 512-byte multiple (copying rows that are not
    16-byte aligned) and views it as uint32 lanes, so the kernel always
    takes its 16-byte vector body."""
    blocks = torch.as_tensor(blocks)
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise ValueError(f"blocks must be (k, nbytes) uint8, got "
                         f"{blocks.dtype} {tuple(blocks.shape)}")
    k, n = blocks.shape
    pad = (-n) % PAD_BYTES
    if pad or blocks.data_ptr() % 16 or not blocks.is_contiguous():
        padded = torch.zeros((k, n + pad), dtype=torch.uint8,
                             device=blocks.device)
        padded[:, :n] = blocks
        blocks = padded
    lanes = blocks.view(torch.uint32)
    return _xor_reduce_kernel(lanes).view(torch.uint8)[:n]


def xor_parity_decode(survivors, parity):
    """Reconstruct the missing block: XOR(survivors..., parity)."""
    parity = torch.as_tensor(parity)
    stack = torch.cat([parity[None], torch.as_tensor(survivors)], dim=0)
    return xor_parity_encode(stack)


def encode_bucket(blocks, *, nbytes: int, want_crc: bool = True,
                  tile_lanes: int = None):
    """Fused snapshot-bucket encode (XOR parity fold + CRC32) on the card
    — see `repro_torch.kernels.stage`.  blocks: (k, n_lanes) uint32.
    Buckets beyond `stage.MAX_CELL_LANES` tile and return per-tile digests
    (fold with `stage.bucket_crc`).  On the card a tile spans at most
    `stage.MAX_CELL_LANES` lanes: a wider `tile_lanes` raises ValueError
    there (the CPU route takes any)."""
    return _encode_bucket_kernel(blocks, nbytes=nbytes, want_crc=want_crc,
                                 tile_lanes=tile_lanes)


def ssd_scan(u, a, Bm, Cm, h0=None, *, chunk: int = 128):
    """Chunked SSD (Mamba2). Same contract as models.ssm.ssm_block's core:
    (y (B,S,H,P), h_final (B,H,P,N))."""
    return _ssd_scan_kernel(u, a, Bm, Cm, h0, chunk=chunk)


def swa_attention(q, k, v, *, window=None, causal: bool = True):
    """Banded flash attention; window is a python int (None = full).  The
    tile sizes are the kernels' own (`swa_attention.BF16_TILES` and the
    fp32 route's `FP32_COLS`, `FP32_ROWS`)."""
    return _swa_flash_kernel(q, k, v, window=window, causal=causal)
