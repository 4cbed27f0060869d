"""The port's bucket encode against the JAX package's Pallas `encode_bucket`
(interpret mode on the CPU, as tests/test_kernels.py runs it): lanes and
per-tile digests bit-exact, `bucket_crc` equal to `zlib.crc32`.

On CPU tensors the port's wrappers run their plain versions; the CUDA
kernel itself is compared with them on the card by chip_smoke.py. Two
Python replays check its arithmetic here: `_kernel_model` replays its CRC
(block and thread segments, the shuffle trees with the operator tables
and the per-launch operator the wrapper passes) against `zlib.crc32`, and
`_gather_model` replays the fused gather's source addressing (realigned
16-byte windows, straddling slices, the loads it may start) against
`DeviceEncoder.gather_bytes`. `encode_ranges`' plain version is held
against the JAX package's `DeviceEncoder.encode` (interpret mode)."""
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from repro.core.pipeline import BucketTask as JaxTask
from repro.core.pipeline import DeviceEncoder as JaxEncoder
from repro.core.treebytes import make_flat_spec as jax_spec
from repro.kernels.stage import bucket_crc as jax_bucket_crc
from repro.kernels.stage import encode_bucket as jax_encode_bucket
from repro_torch import convert
from repro_torch.core.crcutil import CRC_TABLES
from repro_torch.core.pipeline import BucketTask, DeviceEncoder
from repro_torch.core.treebytes import leaf_arrays, make_flat_spec
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


def _zapply(z: np.ndarray, v: int) -> int:
    """csrc `zapply`: an operator's nibble tables (8 x 16) applied to v."""
    s = 0
    for k in range(8):
        s ^= int(z[k, (v >> (4 * k)) & 15])
    return s


def _tree(vals, z_levels):
    """csrc's shuffle tree over 32 lanes: level l, lane i takes
    Z_l v_i ^ v_(i + 2**l) (its own value past lane 31); lane 0's."""
    v = list(vals) + [0] * (32 - len(vals))
    for l, z in enumerate(z_levels):
        d = 1 << l
        v = [_zapply(z, v[i]) ^ (v[i + d] if i + d < 32 else v[i])
             for i in range(32)]
    return v[0]


def _kernel_model(words: np.ndarray, nb: int, tile_lanes: int,
                  nbytes: int, t: int) -> int:
    """Python replay of csrc/encode_bucket.cu's CRC of tile t (folded
    `words`, `nb` live bytes) of a bucket of `nbytes`, with the tables
    and per-launch operators the wrapper passes."""
    T = CRC_TABLES
    S, W, C = stage.ENC_THREADS, stage.ENC_WARPS, stage.ENC_CLUSTER
    lsw = stage.seg_log2(tile_lanes)
    sw, bw = 1 << lsw, stage.ENC_THREADS << lsw
    z = stage.table_words(lsw)[1024:].reshape(stage.ZLEVELS, 8, 16)
    t_last, op_full, op_last = stage.piece_ops(nbytes, tile_lanes, lsw)
    nw, rem = nb // 4, nb % 4
    pieces = []
    for c in range(C):
        live = max(0, min(bw, nw - c * bw))
        raws = []
        for tid in range(S):
            hi = live - (S - 1 - tid) * sw
            lo = max(0, hi - sw)
            r = 0xFFFFFFFF if c == 0 and lo == 0 and hi > 0 else 0
            for w in range(lo, hi):
                x = r ^ int(words[c * bw + w])
                r = int(T[3][x & 255] ^ T[2][(x >> 8) & 255]
                        ^ T[1][(x >> 16) & 255] ^ T[0][x >> 24])
            raws.append(r)
        warps = [_tree(raws[32 * q:32 * q + 32], z[:5]) for q in range(W)]
        piece = _tree(warps, z[5:8])
        tw = nw - c * bw
        if 0 <= tw < bw:
            if nw == 0:
                piece = 0xFFFFFFFF
            for j in range(rem):
                b = (int(words[nw]) >> (8 * j)) & 255
                piece = (piece >> 8) ^ int(T[0][(piece ^ b) & 255])
        pieces.append(piece)
    if nb == 0:
        return 0
    e = (nw - 1) // bw if nw and not rem else nw // bw
    x = 0
    for c in range(e):
        v = pieces[c]
        for l in range(3):
            if ((e - 1 - c) >> l) & 1:
                v = _zapply(z[8 + l], v)
        x ^= v
    op = stage.nibble_table(op_last if t == t_last else op_full)
    return _zapply(op, x) ^ pieces[e] ^ 0xFFFFFFFF


@pytest.mark.parametrize("tile_lanes,nb", [
    (1024, 4096), (1024, 4093), (1024, 2), (1024, 0), (2048, 6150),
    (4096, 9999),                  # nbytes % 4 == 3, a partial block
    (4096, 12001),                 # the last two blocks all padding
    (4096, 4099),                  # tail word opens block 2 (no words)
    (2560, 10240),                 # tile narrower than 8 blocks of 512
    (1 << 16, 262_141),            # single-digest bucket, 32-word segments
    (1 << 15, (1 << 17) - 3),      # a path tile, nbytes % 4 == 1
])
def test_kernel_segment_combine_matches_zlib(tile_lanes, nb):
    rng = np.random.default_rng(nb)
    words = np.zeros(tile_lanes, np.uint32)
    words.view(np.uint8)[:nb] = rng.integers(0, 256, nb, dtype=np.uint8)
    want = zlib.crc32(words.view(np.uint8)[:nb].tobytes())
    # the tile as the last live one of a 3-tile bucket, and as a full
    # tile before it (the two operators the launch carries)
    assert _kernel_model(words, nb, tile_lanes, 2 * 4 * tile_lanes + nb,
                         2) == want
    if nb == 4 * tile_lanes:
        assert _kernel_model(words, nb, tile_lanes, 3 * nb, 0) == want


# ------------------------------------------------------- the fused gather
def _gather_model(slices, row_end: int, nbytes: int, mem: dict):
    """Python replay of csrc `gather16` over a row: slices [(src, lo)],
    `mem` {16-aligned address: 16 bytes} of the sources (vectors holding
    no source byte absent, so a load that reaches one fails)."""
    los = [lo for _, lo in slices]
    out = bytearray()
    for p in range(0, nbytes, 16):
        res = bytearray(16)
        lo_i, hi_i = 0, len(slices)            # the last slice lo <= p
        while hi_i - lo_i > 1:
            m = (lo_i + hi_i) >> 1
            lo_i, hi_i = (m, hi_i) if los[m] <= p else (lo_i, m)
        for s in range(lo_i, len(slices)):
            src, d = slices[s]
            if d >= p + 16:
                break
            e = los[s + 1] if s + 1 < len(slices) else row_end
            blo, bhi = max(p, d) - p, min(p + 16, e) - p
            if bhi <= blo:
                continue
            q = src + (p - d)
            sh = q & 15
            a = mem[q - sh] if sh + blo < 16 else bytes(16)
            b = mem[q - sh + 16] if sh + bhi > 16 else bytes(16)
            win = (a + b)[sh:sh + 16]
            for i in range(blo, bhi):
                res[i] |= win[i]
        out += res
    return bytes(out)


_DTYPES = [np.float32, ml_dtypes.bfloat16, np.uint8, np.bool_, np.int32]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(range(len(_DTYPES))),
                          st.integers(1, 300), st.integers(0, 15)),
                min_size=1, max_size=8),
       st.data())
def test_fused_gather_addressing_matches_gather_bytes(leaves, data):
    rng = np.random.default_rng(len(leaves))
    tree = {f"l{i:02d}": rng.integers(0, 256, n * np.dtype(
        _DTYPES[d]).itemsize, dtype=np.uint8).view(_DTYPES[d])
        for i, (d, n, _) in enumerate(leaves)}
    state = convert.state_from_numpy(tree, device="cpu")
    spec = make_flat_spec(state)
    enc = DeviceEncoder(spec, leaf_arrays(state))
    lo = data.draw(st.integers(0, spec.total_bytes - 1))
    hi = data.draw(st.integers(lo + 1, spec.total_bytes + 700))
    # lay the leaves out at the drawn offsets mod 16, garbage between them
    mem, base, where = {}, 4096, {}
    for i, (_, _, mis) in enumerate(leaves):
        raw = enc._u8(i).numpy().tobytes()
        where[i] = addr = base + mis
        for v in range(addr & ~15, addr + len(raw), 16):
            chunk = bytearray(b"\xa5" * 16)
            for j in range(16):
                if addr <= v + j < addr + len(raw):
                    chunk[j] = raw[v + j - addr]
            mem[v] = bytes(chunk)
        base = (addr + len(raw) + 64) & ~15
    ids = {id(enc._u8(i)): i for i in range(len(leaves))}
    slices, row = [], 0
    for t, start, count in enc.ranges(lo, hi):
        slices.append((where[ids[id(t)]] + start, row))
        row += count
    want = enc.gather_bytes(lo, hi).numpy().tobytes()
    assert _gather_model(slices, row, len(want), mem) == want


def _encoder_state():
    """bf16 leaves of odd sizes (offsets 2 mod 4 after them), an odd-length
    uint8 leaf and a 1-byte leaf between fp32 ones."""
    rng = np.random.default_rng(5)
    return {
        "a_w": rng.standard_normal((33, 31)).astype(ml_dtypes.bfloat16),
        "b_u8": rng.integers(0, 256, 1001, dtype=np.uint8),
        "c_one": np.asarray(True),
        "d_f32": rng.standard_normal(2049).astype(np.float32),
        "e_bf": rng.standard_normal(4097).astype(ml_dtypes.bfloat16),
        "f_i32": np.asarray(7, np.int32),
    }


@pytest.mark.parametrize("kind,bounds,want_crc", [
    (0, [(0, 4096)], None),
    (0, [(2, 3000)], None),              # starts 2 bytes off
    (0, [(2046, 4093)], None),           # the 1-byte leaf and the uint8 one
    (0, [(15000, 20000)], None),         # past total_bytes: the zero pad
    (2, [(2, 1500), (1502, 3000), (7002, 8500)], None),
    (2, [(1001, 1601), (6000, 6600), (16800, 17400)], True),  # delta path
])
def test_encode_ranges_plain_matches_reference_encoder(kind, bounds,
                                                       want_crc):
    tree = _encoder_state()
    jstate = {k: jnp.asarray(v) for k, v in tree.items()}
    tstate = convert.state_from_numpy(tree, device="cpu")
    spec = make_flat_spec(tstate)
    assert spec.to_json() == jax_spec(jstate).to_json()
    (lo, hi), srcs = bounds[0], tuple(bounds)
    task = BucketTask(kind, 0, lo, hi, 0, 0, False,
                      srcs if kind == 2 else ())
    jtask = JaxTask(kind, 0, lo, hi, 0, 0, False, srcs if kind == 2 else ())
    jenc = JaxEncoder(jax_spec(jstate), list(jax.tree.leaves(jstate)),
                      interpret=True)
    enc = DeviceEncoder(spec, leaf_arrays(tstate))
    jl, jc, jnb = jenc.encode(jtask, want_crc=want_crc)
    tl, tc, tnb = enc.encode(task, want_crc=want_crc)
    assert tnb == jnb == hi - lo
    assert np.array_equal(tl.numpy(), np.asarray(jl).view(np.uint8))
    assert np.array_equal(tc.numpy(), np.asarray(jc).view(np.uint8))
    if kind == 0 or want_crc:
        folded = np.bitwise_xor.reduce(np.stack(
            [enc.gather_bytes(a, b).numpy() for a, b in srcs]), axis=0)
        assert enc.bucket_crc(tc.numpy().view(np.uint32), tnb) == \
            zlib.crc32(folded[:tnb].tobytes())
    # the fused entry equals the kernel on the gathered rows
    rows = torch.stack([enc.gather_bytes(a, b) for a, b in srcs])
    out, crc = stage.encode_bucket(rows.view(torch.uint32), nbytes=tnb,
                                   want_crc=kind == 0 or bool(want_crc))
    assert np.array_equal(out.numpy(), tl.numpy().view(np.uint32))
    assert np.array_equal(crc.numpy(), tc.numpy().view(np.uint32))
    assert stage.encode_bucket.launches == 0


def _one_slice(n=64):
    return [[(torch.zeros(n, dtype=torch.uint8), 0, n)]]


@pytest.mark.parametrize("rows,nbytes,err", [
    ([[(torch.zeros(8, dtype=torch.uint8), 0, 1)]
      for _ in range(stage.MAX_ROWS + 1)], 8, ValueError),     # too many rows
    ([[(torch.zeros(8, dtype=torch.int32), 0, 8)]], 8, TypeError),
    ([[(torch.zeros((2, 8), dtype=torch.uint8), 0, 8)]], 8, TypeError),
    ([[(torch.zeros(8, dtype=torch.uint8), 4, 8)]], 8, ValueError),
    ([[(torch.zeros(8, dtype=torch.uint8, device="meta"), 0, 8)]], 8,
     ValueError),                                               # device
    (_one_slice(600), 16, ValueError),        # more bytes than the lanes
    ([[]], 16, ValueError),                   # no slice at all
    (_one_slice(), 0, ValueError),
])
def test_encode_ranges_rejects_what_the_kernel_does_not_take(rows, nbytes,
                                                             err):
    with pytest.raises(err):
        stage.encode_ranges(rows, nbytes=nbytes)


@pytest.mark.parametrize("extra", [0, 1])
def test_encode_ranges_slice_cap(extra):
    n = stage.MAX_SLICES + extra
    t = torch.arange(4 * n, dtype=torch.int32).to(torch.uint8)
    rows = [[(t, 4 * i, 4) for i in range(n)]]
    if extra:
        with pytest.raises(ValueError, match="at most"):
            stage.encode_ranges(rows, nbytes=t.numel())
        return
    out, crc = stage.encode_ranges(rows, nbytes=t.numel())
    assert out.numpy().view(np.uint8)[:t.numel()].tobytes() == \
        t.numpy().tobytes()
    assert stage.bucket_crc(crc.numpy(), t.numel()) == \
        zlib.crc32(t.numpy().tobytes())


@pytest.mark.parametrize("n,tile,want", [
    (128, None, 128),                             # one digest, one tile
    (stage.MAX_CELL_LANES, None, stage.MAX_CELL_LANES),
    (stage.MAX_CELL_LANES + 128, None, stage.TILE_LANES),
    (1 << 20, 1024, 1024),
    (1 << 20, stage.MAX_CELL_LANES + 4, ValueError),   # wider than a cluster
    (1 << 20, 1 << 20, ValueError),        # one digest over 1 << 20 lanes
    (1 << 20, 1026, ValueError),           # not whole 16-byte vectors
])
def test_kernel_tiling_takes_what_one_cluster_holds(n, tile, want):
    if want is ValueError:
        with pytest.raises(ValueError, match="up to"):
            stage.kernel_tiling(n, tile)
        # the CPU route takes any tiling
        blocks = torch.zeros((1, n), dtype=torch.uint32)
        out, crc = stage.encode_bucket(blocks, nbytes=5, tile_lanes=tile)
        assert stage.bucket_crc(crc.numpy(), 5, tile_lanes=tile) == \
            zlib.crc32(bytes(5))
    else:
        assert stage.kernel_tiling(n, tile) == want


@pytest.mark.parametrize("k,nbytes", [(1, 1), (1, 600), (3, 4096)])
def test_encode_ranges_rows_without_slices_are_zeros(k, nbytes):
    t = torch.arange(40, dtype=torch.int32).to(torch.uint8)
    rows = [[] for _ in range(k)]
    rows[-1] = [(t, 3, 30)] if k > 1 else []
    out, crc = stage.encode_ranges(rows, nbytes=nbytes, device="cpu")
    want = np.zeros(len(out) * 4, np.uint8)
    if k > 1:
        want[:30] = t.numpy()[3:33]
    assert out.numpy().view(np.uint8).tobytes() == want.tobytes()
    assert stage.bucket_crc(crc.numpy(), nbytes) == \
        zlib.crc32(want[:nbytes].tobytes())
    # a device the slices are not on, or one the kernel does not run on
    with pytest.raises(ValueError, match="slices on" if k > 1 else "runs on"):
        stage.encode_ranges(rows, nbytes=nbytes, device="meta")
