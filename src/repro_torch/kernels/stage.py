"""Device-side snapshot bucket encode: fused XOR-parity fold + CRC32.

Replaces the TPU kernel `repro/kernels/stage.py::encode_bucket` (Pallas
`_encode_kernel` / `_encode_tiled_kernel`) with a hand-written CUDA kernel
for Hopper (`csrc/encode_bucket.cu`, built for sm_90a by `kernels.build`).

The L1 pump gathers a bucket's scattered leaf byte-ranges into one
contiguous (k, n_lanes) uint32 buffer on the card
(`repro_torch.core.pipeline.DeviceEncoder`); this kernel then

  * XOR-folds the k stacked rows (k == 1 for own-data buckets, a copy;
    k == SG-1 for a fused parity bucket), and
  * computes one zlib-compatible CRC32 per `TILE_LANES` tile of the
    folded row (a single digest for buckets of at most `MAX_CELL_LANES`),

so the host receives ready-to-publish bytes plus digests in one d2h copy.
The (T,) digest contract is the JAX package's, so `bucket_crc` folds them
identically and the port's digests equal the reference's.

On a CPU tensor the wrapper runs `encode_bucket_plain` (a torch XOR fold
and `zlib.crc32` per tile); on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core.crcutil import _zero_operator, crc32_concat

LANE_BYTES = 512              # pad buckets to 128 uint32 lanes x 4 bytes
MAX_CELL_LANES = 1 << 16      # 256 KiB: biggest single-digest bucket
TILE_LANES = 1 << 15          # 128 KiB tiles beyond that

# threads per block of the CUDA kernel: each CRCs one segment of its tile
# (must equal ENC_THREADS in csrc/encode_bucket.cu)
ENC_THREADS = 512
_LEVELS = ENC_THREADS.bit_length() - 1     # tree-combine levels (log2)


def resolve_tile_lanes(n_lanes: int,
                       tile_lanes: Optional[int] = None) -> Optional[int]:
    """CRC tiling decision for an `n_lanes`-lane bucket: None = one digest
    (small bucket), else the tile width in lanes."""
    if tile_lanes is not None:
        return tile_lanes if n_lanes > tile_lanes else None
    return TILE_LANES if n_lanes > MAX_CELL_LANES else None


def _check_blocks(blocks, nbytes: int) -> None:
    if not isinstance(blocks, torch.Tensor):
        raise TypeError(f"blocks must be a torch.Tensor, got {type(blocks)}")
    if blocks.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"blocks must be uint32 (or int32 viewed as "
                        f"uint32), got {blocks.dtype}")
    if blocks.dim() != 2 or blocks.shape[0] < 1:
        raise ValueError(f"blocks must be (k, n_lanes), got "
                         f"{tuple(blocks.shape)}")
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    n = blocks.shape[1]
    if n == 0 or n % (LANE_BYTES // 4):
        raise ValueError(f"n_lanes={n} must be a positive multiple of "
                         f"{LANE_BYTES // 4}")
    if not 0 < nbytes <= 4 * n:
        raise ValueError(f"nbytes={nbytes} outside (0, {4 * n}]")


def encode_bucket_plain(blocks: torch.Tensor, *, nbytes: int,
                        want_crc: bool = True,
                        tile_lanes: Optional[int] = None):
    """Plain version (any device): torch XOR fold, then `zlib.crc32` of
    each tile's live bytes on the host.  Mirrors
    `repro/kernels/ref.py::encode_bucket_ref` with the kernel's tiling."""
    _check_blocks(blocks, nbytes)
    k, n = blocks.shape
    rows = blocks.view(torch.int32)
    acc = rows[0].clone()
    for i in range(1, k):
        acc ^= rows[i]
    out = acc.view(blocks.dtype)
    tl = resolve_tile_lanes(n, tile_lanes) or n
    nt = -(-n // tl)
    crcs = np.zeros(nt, np.uint32)
    if want_crc:
        host = acc.cpu().numpy().view(np.uint8)
        tb = 4 * tl
        for t in range(nt):
            nb = max(0, min(tb, nbytes - t * tb))
            crcs[t] = zlib.crc32(host[t * tb:t * tb + nb])
    crc = torch.from_numpy(crcs).view(torch.int32).to(blocks.device)
    return out, crc.view(blocks.dtype)


# ------------------------------------------------------------------ kernel
_OPS = {}          # (seg_words, device) -> device tensor of zero operators


def _zero_ops(seg_words: int, device: torch.device) -> torch.Tensor:
    """(LEVELS, 32) uint32 GF(2) operators: level l advances a CRC
    register past 4 * seg_words * 2**l zero bytes (the length of the right
    subtree the kernel's tree-combine folds in at that level)."""
    key = (seg_words, device)
    got = _OPS.get(key)
    if got is None:
        cols = [_zero_operator(4 * seg_words << lvl) for lvl in range(_LEVELS)]
        host = torch.from_numpy(np.asarray(cols, np.uint32)).view(torch.int32)
        got = _OPS[key] = host.to(device)
    return got


def encode_bucket(blocks: torch.Tensor, *, nbytes: int,
                  want_crc: bool = True, tile_lanes: Optional[int] = None):
    """Fused bucket encode.  blocks: (k, n_lanes) uint32 (n_lanes % 128
    == 0; bytes past `nbytes` are zero padding).  Returns (encoded
    (n_lanes,), crc (T,)) in blocks' dtype: T == 1 for a bucket of at most
    `MAX_CELL_LANES` lanes, else one digest per tile (fold with
    `bucket_crc`).  Parity callers pass want_crc=False (digests are 0).

    CUDA tensors launch `csrc/encode_bucket.cu` on the current stream
    (bound: (k+1) * 4 * n_lanes bytes at 3.35 TB/s on an H100 SXM); CPU
    tensors run `encode_bucket_plain`."""
    _check_blocks(blocks, nbytes)
    if blocks.device.type == "cpu":
        return encode_bucket_plain(blocks, nbytes=nbytes, want_crc=want_crc,
                                   tile_lanes=tile_lanes)
    if blocks.device.type != "cuda":
        raise ValueError(f"encode_bucket runs on cuda or cpu tensors, not "
                         f"{blocks.device}")
    if blocks.data_ptr() % 16:
        raise ValueError("blocks must be 16-byte aligned")
    k, n = blocks.shape
    tl = resolve_tile_lanes(n, tile_lanes) or n
    if tl % 4:
        raise ValueError(f"tile_lanes={tl} must be a multiple of 4 (the "
                         f"kernel moves 16-byte vectors)")
    nt = -(-n // tl)
    seg_words = -(-tl // ENC_THREADS)
    out = torch.empty(n, dtype=blocks.dtype, device=blocks.device)
    crc = torch.empty(nt, dtype=blocks.dtype, device=blocks.device)
    ops = _zero_ops(seg_words, blocks.device)
    from repro_torch.kernels.build import library
    lib = library("encode_bucket", _SIGNATURES)
    rc = lib.reft_encode_bucket(
        blocks.data_ptr(), k, n, out.data_ptr(), crc.data_ptr(), nbytes,
        tl, nt, int(want_crc), ops.data_ptr(), seg_words,
        blocks.device.index or 0, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"encode_bucket launch failed: "
                           f"{lib.reft_cuda_error_string(rc).decode()}")
    encode_bucket.launches += 1
    return out, crc


encode_bucket.launches = 0     # kernel launches (not plain-version calls)

_SIGNATURES = {
    # blocks, k, n_lanes, out, crc, nbytes, tile_lanes, n_tiles, want_crc,
    # zero_ops, seg_words, device, stream
    "reft_encode_bucket": ([
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p], ctypes.c_int),
    "reft_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def bucket_crc(crc, nbytes: int, tile_lanes: Optional[int] = None) -> int:
    """`encode_bucket` digest(s) -> the bucket's final CRC32: identity for
    the single-digest (1,) shape, a `crc32_combine` fold of consecutive
    per-tile digests for the tiled (T,) shape."""
    arr = np.asarray(crc).reshape(-1).view(np.uint32)
    if arr.size <= 1:
        return int(arr[0]) if arr.size else 0
    words = -(-nbytes // 4)
    if tile_lanes is None:
        # recover the auto tiling: lane counts are padded to LANE_BYTES.
        # The recovered tile count must match EXACTLY — an encode made
        # with an explicit tile_lanes combined at the wrong granularity
        # would fold wrong per-part lengths into a silently bad CRC.
        n_lanes = -(-nbytes // LANE_BYTES) * (LANE_BYTES // 4)
        tile_lanes = resolve_tile_lanes(n_lanes) or n_lanes
        assert -(-n_lanes // tile_lanes) == arr.size, \
            f"{arr.size} tile digests do not match the auto tiling " \
            f"({tile_lanes} lanes/tile over {n_lanes} lanes) — pass the " \
            f"tile_lanes used at encode time"
    else:
        # explicit tiling: extra all-padding tiles digest 0 bytes and
        # combine as identity, but too FEW tiles cannot cover the data
        assert -(-words // tile_lanes) <= arr.size, \
            f"{arr.size} tile digests cannot cover {nbytes} bytes " \
            f"at {tile_lanes} lanes/tile"
    tile_bytes = 4 * tile_lanes
    parts = []
    left = nbytes
    for i in range(arr.size):
        nb = max(0, min(tile_bytes, left))
        parts.append((int(arr[i]), nb))
        left -= tile_bytes
    return crc32_concat(parts)
