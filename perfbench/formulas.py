"""Operations and bytes of the program's kernels and of a model step,
computed from shapes (frozen copies of the arithmetic of the port's
kernel table: each input read once, each output written once; the SSD's
products as three bfloat16 terms each, as its kernels compute them)."""
from __future__ import annotations

from perfbench.peaks import BF16_FLOPS, HBM_BYTES_PER_S
from perfbench.weights import ssm_dims

LANE_BYTES = 512               # encode_bucket pads a row to 128 lanes of 4 B


def chunk_len(S: int, chunk: int) -> int:
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    return Q


def ssd_flops(B, S, H, P, N, Q):
    """(forward, backward) products of the chunked SSD kernels, one term
    each: the causal products count a chunk's Q (Q + 1) / 2 pairs."""
    nc, tri = S // Q, Q * (Q + 1) // 2
    state = nc * H * 2 * P * N * Q
    causal = nc * H * 2 * P * tri
    cb = nc * 2 * N * tri
    return (B * (2 * state + causal + cb),
            B * (5 * state + 2 * causal + 3 * cb))


def ssd_bytes(B, S, H, P, N, Q):
    """(forward, backward) bytes of a training call (no h0, no dh_final),
    fp32: the chunk states hs written by the forward, read by the
    backward."""
    nc = S // Q
    x, ah, bn, st, hs = (B * S * H * P, B * S * H, B * S * N, B * H * P * N,
                         B * H * nc * P * N)
    return 4 * (2 * x + ah + 2 * bn + st + hs), \
        4 * (3 * x + 2 * ah + 4 * bn + hs + st)


def ssd_bound_s(B, S, H, P, N, Q):
    """(forward, backward) least seconds of one call."""
    return tuple(max(3 * f / BF16_FLOPS, b / HBM_BYTES_PER_S) for f, b in
                 zip(ssd_flops(B, S, H, P, N, Q), ssd_bytes(B, S, H, P, N, Q)))


def state_bytes(c: dict) -> int:
    """Bytes of the trained state: parameters in their stored types, two
    fp32 moments a parameter, and the 16 B of counters and RNG key."""
    from perfbench.weights import layout, numel
    n = sum(numel(x.shape) for x in layout(c))
    stored = sum(numel(x.shape) * (2 if x.dtype == "bfloat16" else 4)
                 for x in layout(c))
    return stored + 8 * n + 16


def encode_flight(total: int, n: int, bucket: int):
    """(bytes, launches) of one snapshot round's device encode over an SG
    of n members: each member encodes its n - 1 own blocks (one row: read
    and written) and its parity block (n - 1 rows folded into one), each
    block cut into buckets, every bucket padded to whole lanes."""
    bs = -(-total // (n * (n - 1)))
    full, tail = divmod(bs, bucket)
    sizes = [bucket] * full + ([tail] if tail else [])
    lanes = [-(-s // LANE_BYTES) * LANE_BYTES for s in sizes]
    per_block = sum(lanes)
    moved = n * ((n - 1) * 2 * per_block + n * per_block)
    return moved, n * n * len(sizes)


def model_flops(c: dict, rows: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 x the matmul parameters x the
    tokens, and each forward product of the SSD counted three times
    (forward, and two in the backward); recomputation not counted, nor
    the embedding lookup, norms and element-wise work."""
    L, D, V = c["num_layers"], c["d_model"], c["vocab_size"]
    tokens = rows * seq
    di, H, _ = ssm_dims(c)
    N, P = c["ssm_state"], c["ssm_head_dim"]
    mat = D * (2 * di + 2 * N + H) + di * D
    Q = chunk_len(seq, c["ssd_chunk"])
    extra = 3 * ssd_flops(rows, seq, H, P, N, Q)[0]
    return 6.0 * (L * mat + D * V) * tokens + L * extra
