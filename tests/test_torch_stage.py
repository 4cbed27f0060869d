"""The port's bucket encode against the JAX package's Pallas `encode_bucket`
(interpret mode on the CPU, as tests/test_kernels.py runs it): lanes and
per-tile digests bit-exact, `bucket_crc` equal to `zlib.crc32`.

On CPU tensors the port's wrapper runs its plain version; the CUDA kernel
itself is compared with that plain version on the card by chip_smoke.py.
`test_kernel_segment_combine_matches_zlib` replays the kernel's CRC
algorithm (segments + GF(2) tree combine, with the zero-operator table the
wrapper uploads) in Python, so its arithmetic is checked here too."""
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.stage import bucket_crc as jax_bucket_crc
from repro.kernels.stage import encode_bucket as jax_encode_bucket
from repro_torch.core.crcutil import CRC_TABLES
from repro_torch.kernels import stage

SMALL_TILE = 1 << 14          # keeps the interpret-mode reference quick


def _blocks(k, n_lanes, nbytes, seed):
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 2 ** 32, (k, n_lanes), dtype=np.uint64) \
        .astype(np.uint32)
    raw = b.view(np.uint8).reshape(k, -1)
    raw[:, nbytes:] = 0                          # zero padding past nbytes
    return b


CASES = [
    # (k, n_lanes, nbytes % 4 tail, tile_lanes)
    (1, 4096, 0, None),                  # own bucket, single digest
    (1, 4096, 1, None),
    (3, 4096, 3, None),                  # fused parity, single digest
    (1, 3 * SMALL_TILE + 128, 0, SMALL_TILE),     # tiled, short last tile
    (1, 3 * SMALL_TILE + 128, 3, SMALL_TILE),
    (3, 3 * SMALL_TILE + 128, 1, SMALL_TILE),
]


@pytest.mark.parametrize("k,n_lanes,tail,tile", CASES)
def test_plain_encode_matches_reference(k, n_lanes, tail, tile):
    nbytes = 4 * (n_lanes - 128) + 8 + tail     # last 512 B: padding
    b = _blocks(k, n_lanes, nbytes, seed=k * n_lanes + tail)
    jout, jcrc = jax_encode_bucket(jnp.asarray(b), nbytes=nbytes,
                                   tile_lanes=tile)
    tout, tcrc = stage.encode_bucket(torch.from_numpy(b), nbytes=nbytes,
                                     tile_lanes=tile)
    assert tout.dtype == torch.uint32 and tout.shape == (n_lanes,)
    assert np.array_equal(tout.numpy(), np.asarray(jout))
    assert np.array_equal(tcrc.numpy(), np.asarray(jcrc))
    folded = b[0].copy()
    for row in b[1:]:
        folded ^= row
    want = zlib.crc32(folded.view(np.uint8)[:nbytes].tobytes())
    assert stage.bucket_crc(tcrc.numpy(), nbytes, tile_lanes=tile) == want
    assert jax_bucket_crc(np.asarray(jcrc), nbytes, tile_lanes=tile) == want
    assert stage.encode_bucket.launches == 0     # CPU: plain version only


def test_auto_tiling_and_parity_without_crc():
    n = 1 << 17                                   # > MAX_CELL_LANES: tiled
    b = _blocks(3, n, 4 * n, seed=7)
    out, crc = stage.encode_bucket(torch.from_numpy(b), nbytes=4 * n)
    assert crc.shape == (n // stage.TILE_LANES,)
    assert stage.bucket_crc(crc.numpy(), 4 * n) == \
        zlib.crc32((b[0] ^ b[1] ^ b[2]).tobytes())
    out2, crc2 = stage.encode_bucket(torch.from_numpy(b), nbytes=4 * n,
                                     want_crc=False)
    assert torch.equal(out, out2) and not crc2.numpy().any()
    # int32 lanes are taken as uint32 and keep their dtype
    out3, _ = stage.encode_bucket(torch.from_numpy(b).view(torch.int32),
                                  nbytes=4 * n, want_crc=False)
    assert out3.dtype == torch.int32
    assert np.array_equal(out3.numpy().view(np.uint32), out.numpy())


@pytest.mark.parametrize("bad,err", [
    (torch.zeros((1, 128), dtype=torch.int64), TypeError),
    (torch.zeros((128,), dtype=torch.uint32), ValueError),
    (torch.zeros((1, 100), dtype=torch.uint32), ValueError),
    (torch.zeros((128, 2), dtype=torch.int32).t(), ValueError),
    (torch.zeros((1, 128), dtype=torch.uint32, device="meta"), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        stage.encode_bucket(bad, nbytes=16)


@pytest.mark.parametrize("nbytes", [0, 4 * 128 + 1])
def test_wrapper_rejects_nbytes_outside_the_lanes(nbytes):
    with pytest.raises(ValueError):
        stage.encode_bucket(torch.zeros((1, 128), dtype=torch.uint32),
                            nbytes=nbytes)


def _kernel_model(words: np.ndarray, nb: int, seg: int, ops) -> int:
    """Python replay of csrc/encode_bucket.cu steps 3-5 for one tile."""
    T = CRC_TABLES
    S, levels = stage.ENC_THREADS, ops.shape[0]
    n_words, rem = nb // 4, nb % 4
    part = []
    for tid in range(S):
        hi = n_words - (S - 1 - tid) * seg
        c = 0
        for w in range(max(0, hi - seg), hi):
            x = c ^ int(words[w]) ^ (0xFFFFFFFF if w == 0 else 0)
            c = int(T[3][x & 255] ^ T[2][(x >> 8) & 255]
                    ^ T[1][(x >> 16) & 255] ^ T[0][x >> 24])
        part.append(c)
    for lvl in range(levels):
        st = 1 << lvl
        for tid in range(0, S, 2 * st):
            v, s = part[tid], 0
            for i in range(32):
                if (v >> i) & 1:
                    s ^= int(ops[lvl][i])
            part[tid] = s ^ part[tid + st]
    r = part[0] if n_words else 0xFFFFFFFF
    for j in range(rem):
        b = (int(words[n_words]) >> (8 * j)) & 255
        r = (r >> 8) ^ int(T[0][(r ^ b) & 255])
    return r ^ 0xFFFFFFFF


@pytest.mark.parametrize("tile_lanes,nb", [(1024, 4096), (1024, 4093),
                                           (1024, 2), (1024, 0),
                                           (2048, 6150)])
def test_kernel_segment_combine_matches_zlib(tile_lanes, nb):
    rng = np.random.default_rng(nb)
    words = np.zeros(tile_lanes, np.uint32)
    words.view(np.uint8)[:nb] = rng.integers(0, 256, nb, dtype=np.uint8)
    seg = -(-tile_lanes // stage.ENC_THREADS)
    ops = stage._zero_ops(seg, torch.device("cpu")).numpy().view(np.uint32)
    assert _kernel_model(words, nb, seg, ops) == \
        zlib.crc32(words.view(np.uint8)[:nb].tobytes())
