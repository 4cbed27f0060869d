"""CRC32 helpers for the device-side snapshot encode path.

The device encode kernel (`repro_torch.kernels.stage`) computes one CRC32 per
bucket on the accelerator (slice-by-4 table lookups over uint32 lanes).
Buckets cover the own region exactly once but arrive in schedule order
(optimizer-moments first), so the host recombines the per-bucket digests
into the contiguous own-region CRC with `crc32_combine` — an O(log len)
GF(2) matrix fold per bucket instead of a full zlib pass over the bytes.
The combined value is byte-for-byte what `zlib.crc32` returns over the
same region, so recovery's `verify_crc` needs no changes.
"""
from __future__ import annotations

import functools
from typing import Iterable, Tuple

import numpy as np

_POLY = 0xEDB88320          # reflected CRC-32 (IEEE 802.3), zlib-compatible


def _make_slice4_tables() -> np.ndarray:
    """(4, 256) uint32 lookup tables.  tables[0] is the classic byte-at-a-
    time table; tables[k][i] advances the remainder k extra zero bytes, so
    one uint32 word is consumed with four lookups (slice-by-4)."""
    t0 = np.zeros(256, np.uint64)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        t0[i] = c
    tabs = [t0]
    for _ in range(3):
        prev = tabs[-1]
        t = np.zeros(256, np.uint64)
        for i in range(256):
            t[i] = (prev[i] >> 8) ^ t0[prev[i] & 0xFF]
        tabs.append(t)
    return np.stack(tabs).astype(np.uint32)


CRC_TABLES = _make_slice4_tables()


# ------------------------------------------------------------- combining
def _gf2_times(mat, vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_square(mat):
    return [_gf2_times(mat, mat[i]) for i in range(32)]


@functools.lru_cache(maxsize=256)
def _zero_operator(len2: int) -> tuple:
    """The GF(2) matrix advancing a CRC register past `len2` zero bytes,
    as a tuple of 32 columns.  Cached: the stager recombines one digest
    per bucket and nearly all buckets share a single length, so each
    combine after the first is one 32-step matrix-vector product instead
    of ~45 pure-Python matrix squarings."""
    odd = [0] * 32
    odd[0] = _POLY                       # one zero bit
    for i in range(1, 32):
        odd[i] = 1 << (i - 1)
    even = _gf2_square(odd)              # two zero bits
    odd = _gf2_square(even)              # four zero bits
    op = [1 << i for i in range(32)]     # identity
    while True:
        even = _gf2_square(odd)          # even <- 2x the zero-bits of odd
        if len2 & 1:
            op = [_gf2_times(even, c) for c in op]
        len2 >>= 1
        if not len2:
            break
        odd = _gf2_square(even)
        if len2 & 1:
            op = [_gf2_times(odd, c) for c in op]
        len2 >>= 1
        if not len2:
            break
    return tuple(op)


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC32 of A||B from crc(A), crc(B), len(B) — zlib's crc32_combine
    (not exposed by the `zlib` module).  `crc32_combine(0, crc, n) == crc`,
    so a fold over (crc, len) pairs starts from 0 (the empty-string CRC).

    Inputs are masked to 32 bits: callers hand over digests that may
    ride in wider containers (uint64 device lanes, Python ints from
    signed struct unpacks) — an unmasked bit >= 32 used to index past
    the 32-column GF(2) matrix and raise, and a zero-length B with such
    a crc1 slipped through unmasked entirely."""
    crc1 = int(crc1) & 0xFFFFFFFF
    if int(len2) <= 0:                 # empty B: crc(A||B) == crc(A);
        return crc1                    # numpy scalar lens coerce too
    return _gf2_times(_zero_operator(int(len2)), crc1) \
        ^ (int(crc2) & 0xFFFFFFFF)


def crc32_concat(parts: Iterable[Tuple[int, int]]) -> int:
    """Fold (crc, nbytes) digests of consecutive chunks into one CRC32.
    Zero-length chunks (empty tail parts, padding-only segments) fold to
    identity; single-byte tails exercise `_zero_operator(1)`."""
    crc = 0
    for part_crc, nbytes in parts:
        crc = crc32_combine(crc, part_crc, nbytes)
    return crc
