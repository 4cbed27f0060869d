"""The port's RAIM5 XOR parity against the JAX package's Pallas `xor_reduce`
(interpret mode on the CPU, as tests/test_kernels.py runs it) and its
oracle, and the public kernel entry point (`repro_torch.kernels`) against
`repro.kernels.ops` and the host codec `core/raim5.py`: every result is
compared exactly.

On CPU tensors the port's wrapper runs its plain version; the CUDA kernel
itself is compared with that plain version on the card by chip_smoke.py.
`test_kernel_index_replay` replays the kernel's index arithmetic (the
16-byte vector body and the 4-byte tail, grid-stride over the wrapper's
grid) in numpy, so the offsets it reads and writes are checked here too.
The other kernels' public wrappers and oracles (`kernels/ops.py`,
`kernels/ref.py`) are held against the reference's at small shapes."""
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.xor_parity import xor_reduce as jax_xor_reduce
import repro_torch.kernels as K
from repro_torch.core import raim5
from repro_torch.kernels import ops, ref
from repro_torch.kernels.xor_parity import (XOR_THREADS, grid_size,
                                            vector_count, xor_reduce,
                                            xor_reduce_plain)


def _u32(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("n", [1, 127, 128, 1000, 65537])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_xor_reduce_matches_reference(k, n):
    b = _u32((k, n), seed=k * 100003 + n)
    want = np.asarray(jax_xor_reduce(jnp.asarray(b), interpret=True))
    assert np.array_equal(np.asarray(jax_ref.xor_reduce_ref(jnp.asarray(b))),
                          want)
    got = xor_reduce(torch.from_numpy(b))
    assert got.dtype == torch.uint32 and got.shape == (n,)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ref.xor_reduce_ref(b), want)
    # int32 views pass through as int32, same bits
    got32 = xor_reduce(torch.from_numpy(b.view(np.int32)))
    assert got32.dtype == torch.int32
    assert np.array_equal(got32.numpy().view(np.uint32), want)


@pytest.mark.parametrize("nbytes", [1, 3, 514, 1001, 4099])
def test_parity_encode_decode_match_reference(nbytes):
    """nbytes a multiple of neither 4 nor 512: both pad the lanes."""
    blocks = _u8((3, nbytes), seed=nbytes)
    want = np.asarray(jax_ops.xor_parity_encode(blocks, interpret=True))
    got = ops.xor_parity_encode(torch.from_numpy(blocks))
    assert got.dtype == torch.uint8 and got.shape == (nbytes,)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, raim5.xor_blocks(list(blocks)))
    # lose block 1: parity and the survivors give it back
    surv = blocks[[0, 2]]
    jdec = np.asarray(jax_ops.xor_parity_decode(surv, want, interpret=True))
    dec = K.xor_parity_decode(torch.from_numpy(surv), got)
    assert np.array_equal(dec.numpy(), jdec)
    assert np.array_equal(dec.numpy(), blocks[1])


@pytest.mark.parametrize("layout", ["offset", "strided"])
def test_parity_encode_takes_unaligned_and_strided_rows(layout):
    """Rows of whole 512-byte lanes that start off a 16-byte boundary, or
    that are a strided view, are copied before the uint32 view."""
    raw = _u8(3 * 1024 + 8, seed=11)
    buf = torch.from_numpy(raw)
    if layout == "offset":
        blocks = buf[1:1 + 3 * 1024].view(3, 1024)
    else:
        blocks = buf[:3 * 1024].view(3, 1024)[:, :512]
    want = raim5.xor_blocks([b.numpy().copy() for b in blocks])
    assert np.array_equal(K.xor_parity_encode(blocks).numpy(), want)


def test_parity_of_raim5_stripes_matches_host_codec():
    """Each node's stripe parity through the entry point equals
    `raim5.encode_parity`, and a lost node's blocks decode as
    `raim5.decode_node` decodes them."""
    n, total = 4, 12 * 1000 + 7                # blocks of 1001 B, padded
    full = _u8(total, seed=7)
    bs = raim5.block_size(total, n)
    padded = np.zeros(n * (n - 1) * bs, np.uint8)
    padded[:total] = full
    stripes = torch.from_numpy(padded).view(n, n - 1, bs)
    parity = {s: K.xor_parity_encode(stripes[s]) for s in range(n)}
    for s in range(n):
        assert np.array_equal(parity[s].numpy(),
                              raim5.encode_parity(s, n, full))

    def read_block(node, s, j):
        return stripes[s, j].numpy()

    lost = 2
    host = raim5.decode_node(lost, n, total, read_block,
                             lambda s: parity[s].numpy())
    for ref_ in raim5.data_blocks_of_node(lost, n):
        s, j = ref_.stripe, ref_.index
        surv = stripes[s, [i for i in range(n - 1) if i != j]]
        dec = K.xor_parity_decode(surv, parity[s])
        assert np.array_equal(dec.numpy(), host[(s, j)])
        assert np.array_equal(dec.numpy(), stripes[s, j].numpy())


def _replay(blocks: np.ndarray, data_ptr: int, sm_count: int):
    """`xor_reduce_kernel` over the wrapper's launch, in numpy: every
    thread of the grid runs the vector body (uint4 index r * n_vec + v)
    and then the 4-byte tail, each with its grid stride. Returns the
    output and how often each output word was written."""
    k, n = blocks.shape
    n_vec = vector_count(n, data_ptr)
    threads = grid_size(n, n_vec, sm_count) * XOR_THREADS
    first = np.arange(threads, dtype=np.int64)
    flat = blocks.reshape(-1)
    out = np.zeros(n, np.uint32)
    writes = np.zeros(n, np.int64)
    if n_vec:
        src4 = flat.reshape(-1, 4)            # uint4 view of the rows
        for it in range(-(-n_vec // threads)):
            v = first + it * threads
            v = v[v < n_vec]
            acc = src4[v].copy()
            for r in range(1, k):
                acc ^= src4[r * n_vec + v]
            out.reshape(-1, 4)[v] = acc
            np.add.at(writes, (4 * v[:, None] + np.arange(4)).ravel(), 1)
    for it in range(-(-(n - 4 * n_vec) // threads)):
        t = 4 * n_vec + first + it * threads
        t = t[t < n]
        acc = flat[t].copy()
        for r in range(1, k):
            acc ^= flat[r * n + t]
        out[t] = acc
        np.add.at(writes, t, 1)
    return out, writes, n_vec


@pytest.mark.parametrize("k,n,misaligned,sm_count", [
    (3, 1_000_003, False, 1),          # odd n: the 4-byte body, looping
    (3, 1000, False, 1),               # vector body, one pass
    (8, 65537, False, 132),            # odd n, one pass
    (2, 4 * 300_000, False, 2),        # vector body, grid-stride loops
    (3, 4096, True, 4),                # unaligned base: 4-byte body
    (1, 1, False, 132),
])
def test_kernel_index_replay(k, n, misaligned, sm_count):
    b = _u32((k, n), seed=n + k)
    out, writes, n_vec = _replay(b, 16 * 1001 + 4 * misaligned, sm_count)
    assert n_vec == (0 if (n % 4 or misaligned) else n // 4)
    assert np.array_equal(writes, np.ones(n, np.int64))
    assert np.array_equal(out, xor_reduce_plain(torch.from_numpy(b)).numpy())
    assert grid_size(n, n_vec, sm_count) <= 8 * sm_count


@pytest.mark.parametrize("bad,err", [
    (torch.zeros((2, 8), dtype=torch.uint8), TypeError),
    (torch.zeros(8, dtype=torch.uint32), ValueError),
    (torch.zeros((0, 8), dtype=torch.uint32), ValueError),
    (torch.zeros((2, 0), dtype=torch.uint32), ValueError),
    (torch.zeros((8, 2), dtype=torch.int32).t(), ValueError),
    (torch.zeros((2, 8), dtype=torch.int32, device="meta"), ValueError),
    (np.zeros((2, 8), np.uint32), TypeError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    """A tensor on neither the CPU nor a CUDA device raises: no plain
    fallback off the CPU."""
    with pytest.raises(err):
        xor_reduce(bad)


def test_entry_point_exports_and_launch_count():
    assert set(K.__all__) >= {"bucket_crc", "encode_bucket", "ssd_scan",
                              "swa_attention", "xor_parity_decode",
                              "xor_parity_encode"}
    K.reset_launch_counts()
    K.xor_parity_encode(torch.zeros((2, 100), dtype=torch.uint8))
    assert K.launch_counts()["xor_reduce"] == 0    # plain version: no launch


def test_encode_bucket_wrapper_and_oracle_match_reference():
    k, n, nbytes = 3, 1024, 4 * 1000 + 3
    b = _u32((k, n), seed=5)
    b.view(np.uint8).reshape(k, -1)[:, nbytes:] = 0
    jlanes, jcrc = jax_ref.encode_bucket_ref(b, nbytes)
    lanes, crc = ref.encode_bucket_ref(b, nbytes)
    assert np.array_equal(lanes, jlanes) and crc == jcrc
    jout, jd = jax_ops.encode_bucket(jnp.asarray(b), nbytes=nbytes,
                                     interpret=True)
    out, d = K.encode_bucket(torch.from_numpy(b), nbytes=nbytes)
    assert np.array_equal(out.numpy(), np.asarray(jout))
    assert np.array_equal(d.numpy(), np.asarray(jd))
    assert K.bucket_crc(d.numpy(), nbytes) == zlib.crc32(
        lanes.view(np.uint8)[:nbytes].tobytes())


def test_ssd_scan_wrapper_and_oracle_match_reference():
    """fp32, allclose(atol 5e-4, rtol 1e-3) as tests/test_kernels.py."""
    rng = np.random.default_rng(3)
    B, S, H, P, N = 1, 64, 2, 8, 16
    u = rng.standard_normal((B, S, H, P)).astype(np.float32)
    a = -np.abs(rng.standard_normal((B, S, H))).astype(np.float32) * 0.1
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    jy, jh = jax_ops.ssd_scan(*(jnp.asarray(x) for x in (u, a, Bm, Cm)),
                              chunk=16)
    ry, rh = jax_ref.ssd_scan_ref(*(jnp.asarray(x) for x in (u, a, Bm, Cm)))
    t = [torch.from_numpy(x) for x in (u, a, Bm, Cm)]
    y, h = K.ssd_scan(*t, chunk=16)
    oy, oh = ref.ssd_scan_ref(*t)
    for got, want in ((y, jy), (h, jh), (oy, ry), (oh, rh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("window", [None, 24])
def test_swa_attention_wrapper_and_oracle_match_reference(window):
    """fp32, allclose(atol 2e-5, rtol 1e-4) as tests/test_kernels.py."""
    rng = np.random.default_rng(4)
    B, S, KV, G, hd = 1, 64, 2, 2, 16
    q = rng.standard_normal((B, S, KV, G, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, hd)).astype(np.float32)
            for _ in range(2))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jo = jax_ops.swa_attention(jq, jk, jv, window=window, block_q=16,
                               block_k=16)
    jr = jax_ref.swa_attention_ref(jq, jk, jv, window=window or 1 << 30)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o = K.swa_attention(tq, tk, tv, window=window)
    r = ref.swa_attention_ref(tq, tk, tv, window=window)
    for got, want in ((o, jo), (r, jr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=1e-4)
