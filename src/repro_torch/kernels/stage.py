"""Device-side snapshot bucket encode: fused XOR-parity fold + CRC32.

Replaces the TPU kernel `repro/kernels/stage.py::encode_bucket` (Pallas
`_encode_kernel` / `_encode_tiled_kernel`) with a hand-written CUDA kernel
for Hopper (`csrc/encode_bucket.cu`, built for sm_90a by `kernels.build`).
The kernel

  * XOR-folds k rows of uint32 lanes (k == 1 for own-data buckets, a
    copy; k == SG-1 for a fused parity bucket), and
  * computes one zlib-compatible CRC32 per `TILE_LANES` tile of the
    folded row (a single digest for buckets of at most `MAX_CELL_LANES`),

so the host receives ready-to-publish bytes plus digests in one d2h copy.
The (T,) digest contract is the JAX package's, so `bucket_crc` folds them
identically and the port's digests equal the reference's.

Two entries launch it: `encode_bucket` takes the rows as one contiguous
(k, n_lanes) array; `encode_ranges` takes each row as the leaf byte slices
that make it up and reads them where they lie, so the L1 pump
(`repro_torch.core.pipeline.DeviceEncoder`) gathers nothing itself.

On CPU tensors the wrappers run their plain versions (a torch XOR fold
and `zlib.crc32` per tile; `encode_ranges_plain` concatenates the slices
first); on a CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core.crcutil import (CRC_TABLES, _zero_operator,
                                      crc32_concat)

LANE_BYTES = 512              # pad buckets to 128 uint32 lanes x 4 bytes
MAX_CELL_LANES = 1 << 16      # 256 KiB: biggest single-digest bucket
TILE_LANES = 1 << 15          # 128 KiB tiles beyond that


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
# The CUDA kernel's shape (each must equal its #define in
# csrc/encode_bucket.cu): a tile is one cluster of ENC_CLUSTER blocks of
# ENC_THREADS threads; thread j of a block CRCs one segment of `sw` words
# (a power of two), so a block covers ENC_THREADS * sw lanes of its tile.
ENC_THREADS = 256
ENC_WARPS = ENC_THREADS // 32
ENC_CLUSTER = 8
MAX_SLICES = 128      # leaf slices an `encode_ranges` launch takes
MAX_ROWS = 16         # rows (k) an `encode_ranges` launch takes


def seg_log2(tile_lanes: int) -> int:
    """log2 of the words a thread CRCs: the smallest power of two that
    spreads a `tile_lanes` tile over ENC_CLUSTER * ENC_THREADS threads."""
    sw = -(-tile_lanes // (ENC_CLUSTER * ENC_THREADS))
    return (sw - 1).bit_length()


ZLEVELS = 11          # combine levels: a warp's 5, a block's 3, a tile's 3


def nibble_table(op) -> np.ndarray:
    """A GF(2) operator (32 columns, `_zero_operator`'s layout) as the
    kernel applies it: 8 x 16 uint32, entry [k][x] = op applied to
    x << 4k."""
    out = np.zeros((8, 16), np.uint32)
    for k in range(8):
        for x in range(16):
            v = 0
            for i in range(4):
                if (x >> i) & 1:
                    v ^= int(op[4 * k + i])
            out[k, x] = v
    return out


def table_words(lsw: int) -> np.ndarray:
    """The kernel's constant table for segments of sw = 2**lsw words,
    uint32: the slice-by-4 CRC table (4 x 256), then ZLEVELS operators
    Z(4*sw*2**l) as nibble tables: level l < 5 folds 2**l segments into
    their left neighbours within a warp, levels 5-7 a block's warps,
    levels 8-10 (Z(4*bw*2**m), bw = ENC_THREADS * sw) a tile's blocks."""
    sw = 1 << lsw
    ops = [nibble_table(_zero_operator(4 * sw << l)) for l in range(ZLEVELS)]
    return np.concatenate([CRC_TABLES.reshape(-1)]
                          + [t.reshape(-1) for t in ops])


def last_piece_bytes(nb: int, lsw: int) -> int:
    """How many of a tile's `nb` live bytes its last block with any holds
    (its whole words and, in the block of the tail word, the 1-3 tail
    bytes): the kernel moves the blocks before it past them."""
    nw, rem = divmod(nb, 4)
    bw = ENC_THREADS << lsw
    e = (nw - 1) // bw if nw and not rem else nw // bw
    return 4 * (nw - e * bw) + rem


def piece_ops(nbytes: int, tile_lanes: int, lsw: int):
    """(t_last, op_full, op_last): the last tile with live bytes, and the
    operator Z(last_piece_bytes) the kernel's block 0 applies in a full
    tile and in tile t_last (32 columns each; both depend on nbytes, so
    they travel in the launch's parameters)."""
    t_last = (nbytes - 1) // (4 * tile_lanes)
    return (t_last,
            _zero_operator(last_piece_bytes(4 * tile_lanes, lsw)),
            _zero_operator(last_piece_bytes(
                nbytes - 4 * tile_lanes * t_last, lsw)))


_TABLES = {}       # (lsw, device) -> device tensor of table_words(lsw)


def _tables(lsw: int, device: torch.device) -> torch.Tensor:
    key = (lsw, device)
    got = _TABLES.get(key)
    if got is None:
        host = torch.from_numpy(table_words(lsw).view(np.int32))
        got = host.to(device)
        # launches on other streams read it too: the copy lands first
        torch.cuda.current_stream(device).synchronize()
        _TABLES[key] = got
    return got


class _Slice(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("lo", ctypes.c_longlong)]


class _Args(ctypes.Structure):
    """`EncodeArgs` of csrc/encode_bucket.cu, field for field."""
    _fields_ = [("blocks", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("crc", ctypes.c_void_p), ("tables", ctypes.c_void_p),
                ("n_lanes", ctypes.c_longlong), ("nbytes", ctypes.c_longlong),
                ("row_end", ctypes.c_longlong * MAX_ROWS),
                ("slices", _Slice * MAX_SLICES),
                ("k", ctypes.c_int), ("tile_lanes", ctypes.c_int),
                ("lsw", ctypes.c_int), ("want_crc", ctypes.c_int),
                ("t_last", ctypes.c_int), ("n_slices", ctypes.c_int),
                ("row_first", ctypes.c_int * (MAX_ROWS + 1)),
                ("op_full", ctypes.c_uint32 * 32),
                ("op_last", ctypes.c_uint32 * 32)]


_SIGNATURES = {
    "reft_encode_args_size": ([], ctypes.c_int),
    # args, gather, n_tiles, device, stream
    "reft_encode_bucket": ([ctypes.POINTER(_Args), ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
                           ctypes.c_int),
    "reft_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def kernel_tiling(n_lanes: int, tile_lanes: Optional[int] = None) -> int:
    """The tile width in lanes the kernel runs for an `n_lanes`-lane
    bucket (`resolve_tile_lanes`, a single digest as one tile), or raise
    for one it does not take: a tile is one cluster's shared memory, so
    at most MAX_CELL_LANES lanes, in 16-byte vectors."""
    tl = resolve_tile_lanes(n_lanes, tile_lanes) or n_lanes
    if tl % 4 or tl > MAX_CELL_LANES:
        raise ValueError(f"tile_lanes={tl}: the kernel takes a multiple of "
                         f"4 lanes (16-byte vectors) up to {MAX_CELL_LANES}")
    return tl


def _launch(args: _Args, *, gather: bool, k: int, n: int, nbytes: int,
            want_crc: bool, tile_lanes: Optional[int], device, dtype):
    """Fill the shape fields of `args`, allocate the outputs, launch."""
    tl = kernel_tiling(n, tile_lanes)
    nt = -(-n // tl)
    lsw = seg_log2(tl)
    out = torch.empty(n, dtype=dtype, device=device)
    crc = torch.empty(nt, dtype=dtype, device=device)
    args.out, args.crc = out.data_ptr(), crc.data_ptr()
    args.tables = _tables(lsw, device).data_ptr()
    args.n_lanes, args.nbytes, args.k = n, nbytes, k
    args.tile_lanes, args.lsw, args.want_crc = tl, lsw, int(want_crc)
    if want_crc:
        args.t_last, args.op_full[:], args.op_last[:] = piece_ops(nbytes, tl,
                                                                  lsw)
    from repro_torch.kernels.build import library
    lib = library("encode_bucket", _SIGNATURES)
    if lib.reft_encode_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("encode_bucket: the kernel's EncodeArgs and "
                           "stage._Args differ")
    rc = lib.reft_encode_bucket(ctypes.byref(args), int(gather), nt,
                                device.index or 0,
                                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"encode_bucket launch failed: "
                           f"{lib.reft_cuda_error_string(rc).decode()}")
    encode_bucket.launches += 1
    if k > 1 and want_crc:
        encode_bucket.fold_crc_launches += 1
    return out, crc


def encode_bucket(blocks: torch.Tensor, *, nbytes: int,
                  want_crc: bool = True, tile_lanes: Optional[int] = None):
    """Fused bucket encode.  blocks: (k, n_lanes) uint32 (n_lanes % 128
    == 0; bytes past `nbytes` are zero padding).  Returns (encoded
    (n_lanes,), crc (T,)) in blocks' dtype: T == 1 for a bucket of at most
    `MAX_CELL_LANES` lanes, else one digest per tile (fold with
    `bucket_crc`).  Parity callers pass want_crc=False (digests are 0).

    CUDA tensors launch `csrc/encode_bucket.cu` on the current stream
    (bound: (k+1) * 4 * n_lanes bytes at 3.35 TB/s on an H100 SXM); there
    a tile (or a single digest) spans at most MAX_CELL_LANES lanes, and a
    wider `tile_lanes` raises (`kernel_tiling`).  CPU tensors run
    `encode_bucket_plain`, which takes any tiling."""
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
    args = _Args()
    args.blocks = blocks.data_ptr()
    return _launch(args, gather=False, k=k, n=n, nbytes=nbytes,
                   want_crc=want_crc, tile_lanes=tile_lanes,
                   device=blocks.device, dtype=blocks.dtype)


encode_bucket.launches = 0     # kernel launches of both entries
# of which folded two rows or more and CRC'd the fold: on an SG of 3 or
# more members, the delta path's kind-2 buckets (their digest is the skip
# signal); own buckets are one row, parity without the delta no CRC
encode_bucket.fold_crc_launches = 0


# ------------------------------------------------------- the fused gather
def _check_rows(rows, nbytes: int, device=None):
    """-> (k, n_lanes, device) of `encode_ranges`' rows, or raise; the
    slices' device, which `device` (if given) must be."""
    if not 1 <= len(rows) <= MAX_ROWS:
        raise ValueError(f"encode_ranges takes 1 to {MAX_ROWS} rows, got "
                         f"{len(rows)}")
    n = -(-nbytes // LANE_BYTES) * (LANE_BYTES // 4)
    if nbytes <= 0:
        raise ValueError(f"nbytes={nbytes} must be positive")
    device = None if device is None else torch.device(device)
    n_slices = 0
    for row in rows:
        covered = 0
        for t, start, count in row:
            if not isinstance(t, torch.Tensor) or t.dtype != torch.uint8 \
                    or t.dim() != 1 or not t.is_contiguous():
                raise TypeError("encode_ranges slices must be 1-D "
                                "contiguous uint8 tensors")
            if device is None or (device.index is None
                                  and t.device.type == device.type):
                device = t.device
            elif t.device != device:
                raise ValueError(f"encode_ranges slices on {device} and "
                                 f"{t.device}")
            if start < 0 or count < 0 or start + count > t.numel():
                raise ValueError(f"slice [{start}, {start + count}) outside "
                                 f"a tensor of {t.numel()} bytes")
            covered += count
            n_slices += count > 0
        if covered > 4 * n:
            raise ValueError(f"a row's slices hold {covered} bytes, more "
                             f"than the bucket's {4 * n}")
    if device is None:
        raise ValueError("encode_ranges needs a slice or a device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"encode_ranges runs on cuda or cpu tensors, not "
                         f"{device}")
    if n_slices > MAX_SLICES:
        raise ValueError(f"{n_slices} slices: the kernel takes at most "
                         f"{MAX_SLICES} a launch")
    return len(rows), n, device


def encode_ranges_plain(rows, *, nbytes: int, want_crc: bool = True,
                        device=None):
    """Plain version (any device): each row's slices and its zero pad
    concatenated with `torch.cat`, the rows stacked, then
    `encode_bucket_plain`."""
    k, n, device = _check_rows(rows, nbytes, device)
    stacked = []
    for row in rows:
        parts = [t[start:start + count] for t, start, count in row]
        pad = 4 * n - sum(count for _, _, count in row)
        parts.append(torch.zeros(pad, dtype=torch.uint8, device=device))
        stacked.append(torch.cat(parts))
    blocks = torch.stack(stacked).view(torch.uint32)
    return encode_bucket_plain(blocks, nbytes=nbytes, want_crc=want_crc)


def encode_ranges(rows, *, nbytes: int, want_crc: bool = True,
                  device=None):
    """`encode_bucket` with the gather fused in.  rows: k sequences of
    `(uint8 tensor, start, count)` slices; row r is its slices' bytes
    back to back, then zeros up to n_lanes = ceil(nbytes / LANE_BYTES) *
    128 lanes (a row may have no slice: all zeros).  Returns what
    `encode_bucket(stack(rows), nbytes=nbytes, ...)` returns (uint32),
    byte for byte, digests included.  `device` is the slices' device,
    needed only when no row has a slice.

    CUDA tensors launch the kernel, which reads the slices where they lie
    (any byte alignment) on the current stream: at most MAX_SLICES slices
    and MAX_ROWS rows a launch, passed in its parameters (no copy to the
    card).  CPU tensors run `encode_ranges_plain`."""
    k, n, device = _check_rows(rows, nbytes, device)
    if device.type == "cpu":
        return encode_ranges_plain(rows, nbytes=nbytes, want_crc=want_crc,
                                   device=device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    args = _Args()
    s = 0
    for r, row in enumerate(rows):
        args.row_first[r] = s
        lo = 0
        for t, start, count in row:
            if count:
                args.slices[s].src = t.data_ptr() + start
                args.slices[s].lo = lo
                lo += count
                s += 1
        args.row_end[r] = lo
    args.row_first[k] = s
    args.n_slices = s
    return _launch(args, gather=True, k=k, n=n, nbytes=nbytes,
                   want_crc=want_crc, tile_lanes=None, device=device,
                   dtype=torch.uint32)


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
