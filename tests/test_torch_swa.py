"""The port's sliding-window flash attention against the JAX package's, on
the CPU.

* `swa_flash_plain` and `swa_flash` on CPU tensors against JAX `swa_flash`
  (the Pallas kernel in interpret mode, as tests/test_kernels.py runs it)
  and `kernels/ref.py::swa_attention_ref`, on tests/test_kernels.py's sweep
  (float32: atol 2e-5, rtol 1e-4) and its bfloat16 case (atol and rtol
  3e-2 against the float32 reference).
* `flash_attention(band=W)` against its own unbanded result (equal: the
  skipped blocks add exact zeros) and against JAX `flash_attention` with
  the same band (rtol 1e-5, atol 1e-6).
* The plain version's autograd against `jax.vjp` of
  `repro.models.flash.flash_attention` (float32, rtol 1e-4, atol 1e-5).
* Replays of the CUDA kernels' algorithms in plain torch loops: their
  tiles, band tile ranges, the NEG_INF sentinel, lse, D and the
  fixed-order group sums of dK and dV. The kernels run only on the card,
  so this is where their algebra is checked. The fp32 route's three
  kernels (csrc/swa_flash.cu) against the plain version (atol 2e-5, rtol
  1e-4) and its autograd (rtol 1e-4, atol 1e-5: the same float32 math,
  summed in another order); the bf16 route's (csrc/swa_flash_bf16.cu: its
  tile geometry, P and dS rounded to bf16 before the products that take
  them, D from the pre-pass) against JAX `flash_attention` and its
  `jax.vjp` on the same bf16 inputs (atol and rtol 3e-2); the geometry
  constants of swa_attention.py against both sources, parsed; and
  `SWAFlash` driven by the fp32 replays in place of the kernels, with and
  without `torch.utils.checkpoint` (rtol 1e-4, atol 1e-5 of the largest
  gradient: that loss sums squares, so its gradients run large).
* The wrappers' input checks, `swa_flash` on CPU and meta tensors, and
  `build.resource_report` (the bf16 kernels' registers and spills).
"""
import importlib
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.ref import swa_attention_ref
from repro.kernels.swa_attention import swa_flash as jax_swa_flash
from repro.models.flash import flash_attention as jax_flash
from repro_torch.models.flash import NEG_INF, flash_attention
from repro_torch.models.layers import FULL_WINDOW

# the package names the public function `swa_attention`, as the reference
# does
K = importlib.import_module("repro_torch.kernels.swa_attention")

SWEEP = [                            # tests/test_kernels.py's sweep
    (2, 128, 2, 3, 16, None, True),
    (1, 256, 2, 2, 64, 37, True),
    (2, 128, 1, 4, 32, 64, False),
    (1, 512, 2, 1, 16, 128, True),
    (1, 128, 4, 1, 8, 1, True),      # degenerate window
]


def _qkv(B, S, KV, G, hd, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"q": f(B, S, KV, G, hd), "k": f(B, S, KV, hd),
            "v": f(B, S, KV, hd), "do": f(B, S, KV, G, hd)}


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


@pytest.mark.parametrize("B,S,KV,G,hd,w,causal", SWEEP)
def test_plain_matches_reference(B, S, KV, G, hd, w, causal):
    x = _qkv(B, S, KV, G, hd)
    q, k, v = (jnp.asarray(x[n]) for n in "qkv")
    want_kernel = np.asarray(jax_swa_flash(q, k, v, window=w, causal=causal,
                                           block_q=64, block_k=32))
    want_ref = np.asarray(swa_attention_ref(q, k, v, window=w or FULL_WINDOW,
                                            causal=causal))
    tq, tk, tv = (_t(x[n]) for n in "qkv")
    for got in (K.swa_flash_plain(tq, tk, tv, window=w, causal=causal),
                K.swa_flash(tq, tk, tv, window=w, causal=causal)):
        assert got.dtype == torch.float32
        for want in (want_kernel, want_ref):
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5,
                                       rtol=1e-4)


def test_plain_bf16_matches_reference():
    """tests/test_kernels.py's bf16 case: bf16 in, bf16 out."""
    x = _qkv(1, 128, 2, 2, 32, seed=1)
    bf = {n: jnp.asarray(x[n]).astype(jnp.bfloat16) for n in "qkv"}
    want = np.asarray(swa_attention_ref(*(bf[n].astype(jnp.float32)
                                          for n in "qkv"), window=32))
    jk = np.asarray(jax_swa_flash(bf["q"], bf["k"], bf["v"], window=32,
                                  block_q=64, block_k=64), np.float32)
    tq, tk, tv = (_t(np.asarray(bf[n], np.float32), torch.bfloat16)
                  for n in "qkv")
    got = K.swa_flash(tq, tk, tv, window=32, causal=True)
    assert got.dtype == torch.bfloat16
    for ref in (want, jk):
        np.testing.assert_allclose(got.float().numpy(), ref, atol=3e-2,
                                   rtol=3e-2)


@pytest.mark.parametrize("window,causal", [(24, True), (24, False),
                                           (1, True), (100, False)])
def test_band_skips_blocks_without_changing_values(window, causal):
    x = _qkv(2, 128, 2, 2, 16, seed=2)
    tq, tk, tv = (_t(x[n]) for n in "qkv")
    kw = dict(window=window, causal=causal, block_q=16, block_k=32)
    full = flash_attention(tq, tk, tv, **kw)
    banded = flash_attention(tq, tk, tv, band=window, **kw)
    assert torch.equal(full, banded)
    want = jax_flash(*(jnp.asarray(x[n]) for n in "qkv"), band=window, **kw)
    np.testing.assert_allclose(banded.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


GRAD_CASES = [(2, 64, 2, 2, 16, 24, True), (1, 96, 1, 3, 32, 40, False),
              (1, 64, 2, 2, 16, None, True)]


def _plain_grads(x, w, causal, fn=None):
    leaves = [_t(x[n]).requires_grad_(True) for n in "qkv"]
    fn = fn or (lambda q, k, v: K.swa_flash_plain(q, k, v, window=w,
                                                  causal=causal))
    o = fn(*leaves)
    return o.detach(), torch.autograd.grad(o, leaves, _t(x["do"]))


@pytest.mark.parametrize("B,S,KV,G,hd,w,causal", GRAD_CASES)
def test_plain_grads_match_jax_vjp(B, S, KV, G, hd, w, causal):
    x = _qkv(B, S, KV, G, hd, seed=3)
    W = w or FULL_WINDOW
    _, got = _plain_grads(x, w, causal)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, window=W, causal=causal, block_q=32, block_k=32,
        band=w), *(jnp.asarray(x[n]) for n in "qkv"))
    want = vjp(jnp.asarray(x["do"]))
    for name, g, wg in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


# ----------------------------------------------- replays of the CUDA kernels
def _scale(hd):
    return float(np.float32(hd ** -0.5))


def _rows(x, lo, n, S):
    """Rows lo .. lo+n-1 of axis 1 as float32, zeros past S (the kernels'
    zero-filled tile rows)."""
    part = x[:, lo:min(lo + n, S)].float()
    pad = n - part.shape[1]
    if pad:
        shape = list(part.shape)
        shape[1] = pad
        part = torch.cat([part, part.new_zeros(shape)], 1)
    return part


def _visible(qpos, kpos, window, causal, Sq, Sk):
    ok = (qpos[:, None] < Sq) & (kpos[None, :] < Sk)
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    return ok & (qpos[:, None] - kpos[None, :] < window) \
        & (kpos[None, :] - qpos[:, None] < window)


def _bf16(x):
    """x rounded to bfloat16, back in float32: a rounding point of the
    bf16 kernels (P and dS before the products that take them)."""
    return x.to(torch.bfloat16).float()


def kv_band(q_lo, q_hi, Sk, window, causal, C=K.FP32_COLS):
    """The KV tiles (of C) that meet query rows [q_lo, q_hi]."""
    nk = -(-Sk // C)
    lo = max(0, q_lo - window + 1)
    hi = q_hi if causal else q_hi + window - 1
    return range(lo // C, min(nk - 1, hi // C) + 1)


def q_band(k_lo, k_hi, Sq, window, causal, C=K.FP32_COLS):
    """The query tiles (of C) that meet KV rows [k_lo, k_hi]."""
    nq = -(-Sq // C)
    lo = k_lo if causal else max(0, k_lo - window + 1)
    hi = k_hi + window - 1
    return range(lo // C, min(nq - 1, hi // C) + 1)


def replay_forward(q, k, v, window, causal, *, rows=K.FP32_ROWS,
                   cols=K.FP32_COLS, lowp=False):
    """The forward kernels: block (b, kv, g, tile of `rows` query rows)
    walks its band's KV tiles (of `cols`) with the online softmax in fp32;
    masked scores are NEG_INF; o = acc / max(l, 1e-30) in q's type,
    lse = m + log l. `lowp` (the bf16 kernel): P is rounded to bf16 before
    P V; l sums the unrounded p."""
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    R, C, sc = rows, cols, _scale(hd)
    o = torch.zeros(B, Sq, KV, G, hd)
    lse = torch.zeros(B, KV, G, Sq)
    for q_lo in range(0, Sq, R):
        q_hi = min(q_lo + R, Sq) - 1
        qt = _rows(q, q_lo, R, Sq)                       # (B,R,KV,G,hd)
        qpos = q_lo + torch.arange(R)
        m = torch.full((B, KV, G, R), NEG_INF)
        l = torch.zeros(B, KV, G, R)
        acc = torch.zeros(B, KV, G, R, hd)
        for kt in kv_band(q_lo, q_hi, Sk, window, causal, C):
            kk, vv = (_rows(t, kt * C, C, Sk) for t in (k, v))
            s = torch.einsum("brkgd,bckd->bkgrc", qt, kk)
            ok = _visible(qpos, kt * C + torch.arange(C), window, causal,
                          Sq, Sk)
            s = torch.where(ok, s * sc, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            m = m_new
            acc = acc * corr[..., None] + torch.einsum(
                "bkgrc,bckd->bkgrd", _bf16(p) if lowp else p, vv)
        n = q_hi - q_lo + 1
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        o[:, q_lo:q_hi + 1] = out.permute(0, 3, 1, 2, 4)[:, :n]
        lse[..., q_lo:q_hi + 1] = (m + torch.log(l))[..., :n]
    return o.to(q.dtype), lse


def _row_dots(do, o, lo, n, S):
    """D = rowsum(dO o O) in fp32 over rows lo .. lo+n-1 (0 past S)."""
    return (_rows(do, lo, n, S) * _rows(o, lo, n, S)).sum(-1)


def replay_pre_pass(do, o):
    """dot_kernel (bf16 backward): D = rowsum(dO o O) in fp32, once a row,
    as (B, KV, G, Sq)."""
    return (do.float() * o.float()).sum(-1).permute(0, 2, 3, 1)


def replay_bwd_dq(do, q, k, v, o, lse, window, causal, *, rows=None,
                  cols=K.FP32_COLS, lowp=False, D=None):
    """The dQ kernels: block (b, kv, g, tile of `rows` query rows; fp32:
    FP32_BWD_ROWS[hd]) takes D (fp32: its own, from dO and O; bf16: the
    pre-pass's), then per KV tile (of `cols`) of its band dP = dO V^T,
    P = exp(S - lse), dS = P (dP - D), dQ += dS K; dq = scale dQ. `lowp`:
    dS is rounded to bf16 before dS K."""
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    R, C, sc = rows or K.FP32_BWD_ROWS[hd], cols, _scale(hd)
    dq = torch.zeros(B, Sq, KV, G, hd)
    for q_lo in range(0, Sq, R):
        q_hi = min(q_lo + R, Sq) - 1
        qt, dot = _rows(q, q_lo, R, Sq), _rows(do, q_lo, R, Sq)
        Dt = torch.zeros(B, KV, G, R)
        L = torch.zeros(B, KV, G, R)
        if D is None:
            Dt = _row_dots(do, o, q_lo, R, Sq).permute(0, 2, 3, 1)
        else:
            Dt[..., :q_hi - q_lo + 1] = D[..., q_lo:q_hi + 1]
        L[..., :q_hi - q_lo + 1] = lse[..., q_lo:q_hi + 1]
        qpos = q_lo + torch.arange(R)
        acc = torch.zeros(B, KV, G, R, hd)
        for kt in kv_band(q_lo, q_hi, Sk, window, causal, C):
            kk, vv = (_rows(t, kt * C, C, Sk) for t in (k, v))
            dp = torch.einsum("brkgd,bckd->bkgrc", dot, vv)
            s = torch.einsum("brkgd,bckd->bkgrc", qt, kk)
            ok = _visible(qpos, kt * C + torch.arange(C), window, causal,
                          Sq, Sk)
            p = torch.exp(torch.where(ok, s * sc, torch.tensor(NEG_INF))
                          - L[..., None])
            ds = p * (dp - Dt[..., None])
            acc = acc + torch.einsum("bkgrc,bckd->bkgrd",
                                     _bf16(ds) if lowp else ds, kk)
        n = q_hi - q_lo + 1
        dq[:, q_lo:q_hi + 1] = (acc * sc).permute(0, 3, 1, 2, 4)[:, :n]
    return dq.to(q.dtype)


def replay_bwd_dkdv(do, q, k, v, o, lse, window, causal, *, rows=None,
                    cols=K.FP32_COLS, lowp=False, D=None):
    """The dK/dV kernels: block (b, kv, tile of `rows` KV rows; fp32:
    FP32_BWD_ROWS[hd]) loops over g, then over its band's query tiles (of
    `cols`) in order, and sums dV += P^T dO, dK += dS^T Q; dk = scale dK.
    `lowp`: P^T and dS^T are rounded to bf16 before those products, and D
    is the pre-pass's."""
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    R, C, sc = rows or K.FP32_BWD_ROWS[hd], cols, _scale(hd)
    dk = torch.zeros(B, Sk, KV, hd)
    dv = torch.zeros(B, Sk, KV, hd)
    for k_lo in range(0, Sk, R):
        k_hi = min(k_lo + R, Sk) - 1
        kk, vv = (_rows(t, k_lo, R, Sk) for t in (k, v))    # (B,R,KV,hd)
        kpos = k_lo + torch.arange(R)
        dK = torch.zeros(B, KV, R, hd)
        dV = torch.zeros(B, KV, R, hd)
        for g in range(G):
            for it in q_band(k_lo, k_hi, Sq, window, causal, C):
                q_lo = it * C
                qt = _rows(q[:, :, :, g], q_lo, C, Sq)      # (B,C,KV,hd)
                dot = _rows(do[:, :, :, g], q_lo, C, Sq)
                n = min(q_lo + C, Sq) - q_lo
                if D is None:
                    Dt = _row_dots(do[:, :, :, g], o[:, :, :, g], q_lo, C,
                                   Sq)                      # (B,C,KV)
                else:
                    Dt = torch.zeros(B, C, KV)
                    Dt[:, :n] = D[:, :, g, q_lo:q_lo + n].permute(0, 2, 1)
                L = torch.zeros(B, KV, C)
                L[..., :n] = lse[:, :, g, q_lo:q_lo + n]
                s = torch.einsum("brkd,bckd->bkrc", kk, qt)
                dp = torch.einsum("brkd,bckd->bkrc", vv, dot)
                ok = _visible(q_lo + torch.arange(C), kpos, window, causal,
                              Sq, Sk).T                    # (R, C)
                p = torch.exp(torch.where(ok, s * sc,
                                          torch.tensor(NEG_INF))
                              - L[:, :, None, :])
                ds = p * (dp - Dt.permute(0, 2, 1)[:, :, None, :])
                if lowp:
                    p, ds = _bf16(p), _bf16(ds)
                dV = dV + torch.einsum("bkrc,bckd->bkrd", p, dot)
                dK = dK + torch.einsum("bkrc,bckd->bkrd", ds, qt)
        n = k_hi - k_lo + 1
        dk[:, k_lo:k_hi + 1] = (dK * sc).permute(0, 2, 1, 3)[:, :n]
        dv[:, k_lo:k_hi + 1] = dV.permute(0, 2, 1, 3)[:, :n]
    return dk.to(k.dtype), dv.to(v.dtype)


def replay_backward(do, q, k, v, o, lse, *, window, causal=True):
    """What `swa_flash_bwd` returns on fp32 inputs: the dQ kernel, then the
    dK/dV one."""
    dq = replay_bwd_dq(do, q, k, v, o, lse, window, causal)
    return (dq, *replay_bwd_dkdv(do, q, k, v, o, lse, window, causal))


def replay_forward_bf16(q, k, v, window, causal):
    """What `swa_flash_fwd` returns on bf16 inputs (fwd_kernel of
    csrc/swa_flash_bf16.cu), at its tile geometry."""
    t = K.BF16_TILES[q.shape[-1]]
    return replay_forward(q, k, v, window, causal, rows=K.BF16_FWD_ROWS,
                          cols=t["fwd_cols"], lowp=True)


def replay_backward_bf16(do, q, k, v, o, lse, *, window, causal=True):
    """What `swa_flash_bwd` returns on bf16 inputs: the D pre-pass, the dQ
    kernel, then the dK/dV one, at their tile geometry."""
    t = K.BF16_TILES[q.shape[-1]]
    D = replay_pre_pass(do, o)
    dq = replay_bwd_dq(do, q, k, v, o, lse, window, causal,
                       rows=K.BF16_DQ_ROWS, cols=t["dq_cols"], lowp=True,
                       D=D)
    return (dq, *replay_bwd_dkdv(do, q, k, v, o, lse, window, causal,
                                 rows=t["dkdv_rows"],
                                 cols=K.BF16_DKDV_COLS, lowp=True, D=D))


REPLAY_CASES = [
    # B, S, KV, G, hd, window, causal
    (1, 200, 2, 3, 64, 70, True),      # ragged last tile, band edges
    (2, 160, 1, 2, 64, None, True),    # full causal
    (1, 150, 2, 2, 64, 50, False),     # non-causal band, both sides
    (1, 130, 1, 2, 64, FULL_WINDOW, False),
    (1, 128, 2, 1, 64, 1, True),       # degenerate window
    (1, 96, 1, 2, 256, 40, True),      # hd 256: 32-row backward tiles
    (1, 100, 2, 2, 128, 65, True),     # starcoder2's head width
]


@pytest.mark.parametrize("B,S,KV,G,hd,w,causal", REPLAY_CASES)
def test_kernel_algorithms_replayed_match_plain(B, S, KV, G, hd, w, causal):
    x = _qkv(B, S, KV, G, hd, seed=4)
    W = K._window(w)
    tq, tk, tv, tdo = (_t(x[n]) for n in ("q", "k", "v", "do"))
    o, lse = replay_forward(tq, tk, tv, W, causal)
    want_o, want_g = _plain_grads(x, w, causal)
    np.testing.assert_allclose(o.numpy(), want_o.numpy(), atol=2e-5,
                               rtol=1e-4)
    # lse is the log-sum-exp of each row's visible scores
    s = torch.einsum("bqkgd,bskd->bkgqs", tq, tk) * _scale(hd)
    ok = _visible(torch.arange(S), torch.arange(S), W, causal, S, S)
    want_lse = torch.logsumexp(torch.where(ok, s, torch.tensor(-math.inf)),
                               -1)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-5,
                               atol=1e-5)
    got = replay_backward(tdo, tq, tk, tv, o, lse, window=W, causal=causal)
    for name, g, wg in zip("qkv", got, want_g):
        np.testing.assert_allclose(g.numpy(), wg.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_replayed_forward_wipes_rows_that_start_masked():
    """A query tile whose first KV tile holds none of some rows' keys: the
    sentinel gives those rows p = 1 there, and corr = 0 wipes it exactly
    (with -inf they would be NaN)."""
    x = _qkv(1, 192, 1, 1, 64, seed=5)
    tq, tk, tv = (_t(x[n]) for n in "qkv")
    q_lo = K.FP32_ROWS * 2                           # rows 128..191
    first = kv_band(q_lo, q_lo + K.FP32_ROWS - 1, 192, 70, True)[0]
    assert first * K.FP32_COLS + K.FP32_COLS - 1 \
        < q_lo + K.FP32_ROWS - 1 - 70 + 1
    o, lse = replay_forward(tq, tk, tv, 70, True)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(o.numpy(), K.swa_flash_plain(
        tq, tk, tv, window=70, causal=True).numpy(), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("B,S,KV,G,hd,w,causal", REPLAY_CASES + [
    (1, 160, 2, 2, 64, 48, True)])     # the path's bf16 at a narrow width
def test_replayed_kernels_bf16(B, S, KV, G, hd, w, causal):
    """The bf16 kernels' replays (tile geometry of BF16_TILES, P and dS
    rounded to bf16 before the products that take them, D from the
    pre-pass, bf16 out) against the JAX package's
    `models/flash.py::flash_attention` and its `jax.vjp` on the same
    numpy-seeded bf16 inputs: atol and rtol 3e-2, the bf16 tolerance of
    tests/test_kernels.py."""
    x = _qkv(B, S, KV, G, hd, seed=6)
    W = K._window(w)
    bf = {n: jnp.asarray(x[n]).astype(jnp.bfloat16)
          for n in ("q", "k", "v", "do")}
    tq, tk, tv, tdo = (_t(np.asarray(bf[n], np.float32), torch.bfloat16)
                       for n in ("q", "k", "v", "do"))
    o, lse = replay_forward_bf16(tq, tk, tv, W, causal)
    assert o.dtype == torch.bfloat16
    want_o, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, window=W, causal=causal, block_q=32, block_k=32,
        band=w), bf["q"], bf["k"], bf["v"])
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(want_o, np.float32), atol=3e-2,
                               rtol=3e-2)
    got = replay_backward_bf16(tdo, tq, tk, tv, o, lse, window=W,
                               causal=causal)
    for name, g, wg in zip("qkv", got, vjp(bf["do"])):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(wg, np.float32), atol=3e-2,
                                   rtol=3e-2, err_msg=name)


def test_replayed_pre_pass_is_the_row_dots():
    """The bf16 backward's D pre-pass equals the fp32 kernels' per-tile
    row dots on the same values."""
    x = _qkv(1, 150, 2, 3, 64, seed=12)
    do, o = (_t(x[n], torch.bfloat16) for n in ("do", "q"))
    D = replay_pre_pass(do, o)
    want = _row_dots(do, o, 0, 150, 150).permute(0, 2, 3, 1)
    np.testing.assert_allclose(D.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-5)


def _cuda_geometry(path):
    """The tile constants a CUDA source states: its #defines and, in
    swa_flash_bf16.cu, one `struct Geo<hd>` line per head width."""
    import re
    src = (Path(K.__file__).parent / "csrc" / path).read_text()
    defines = {m[1]: int(m[2]) for m in
               re.finditer(r"^#define (\w+) (\d+)\b", src, re.M)}
    geo = {int(m[1]): {"fwd_cols": int(m[2]), "dq_cols": int(m[3]),
                       "dkdv_rows": int(m[4])} for m in re.finditer(
        r"struct Geo<(\d+)> \{ static constexpr int fwd_cols = (\d+), "
        r"dq_cols = (\d+), dkdv_rows = (\d+); \};", src)}
    bwd_ty = re.search(r"struct BwdTY \{ static constexpr int value = "
                       r"HD == 256 \? (\d+) : (\d+); \};", src)
    return defines, geo, bwd_ty


def test_geometry_constants_match_the_cuda_sources():
    """The tile geometry the replays (and the wrappers' docs) use is the
    one the kernels are compiled with: swa_attention.py's constants
    against the #defines and constexprs parsed from both sources."""
    d, geo, _ = _cuda_geometry("swa_flash_bf16.cu")
    assert (d["STAGES"], d["FWD_ROWS"], d["DQ_ROWS"], d["DKDV_COLS"]) == (
        K.BF16_STAGES, K.BF16_FWD_ROWS, K.BF16_DQ_ROWS, K.BF16_DKDV_COLS)
    assert geo == K.BF16_TILES
    assert tuple(sorted(geo)) == K.HEAD_DIMS
    # two consumer warpgroups of 64 rows each
    assert d["THREADS"] == 384 and K.BF16_FWD_ROWS == K.BF16_DQ_ROWS == 128
    d, _, bwd_ty = _cuda_geometry("swa_flash.cu")
    assert d["COLS"] == K.FP32_COLS and 4 * d["FWD_TY"] == K.FP32_ROWS
    assert {hd: 4 * int(bwd_ty[1] if hd == 256 else bwd_ty[2])
            for hd in K.HEAD_DIMS} == K.FP32_BWD_ROWS


# ---------------------------------------------------------------- wrappers
def test_wrappers_reject_bad_inputs():
    x = _qkv(1, 64, 2, 2, 64, seed=7)
    q, k, v = (_t(x[n]) for n in "qkv")
    for fn in (lambda *a: K.swa_flash(*a, window=8),
               lambda *a: K.swa_flash_fwd(*a, window=8)):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fn(q.double(), k.double(), v.double())
        with pytest.raises(TypeError, match="q is"):
            fn(q, k.to(torch.bfloat16), v)
        with pytest.raises(ValueError, match="rank"):
            fn(q[0], k, v)
        with pytest.raises(ValueError, match="Sk, KV, hd"):
            fn(q, k[..., :-1], v[..., :-1])
        with pytest.raises(ValueError, match="window"):
            K.swa_flash(q, k, v, window=0)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """On the CUDA path: a head width without a kernel, a non-contiguous
    input (no silent copy), a CPU tensor; nothing launches."""
    x = _qkv(1, 64, 2, 2, 64, seed=8)
    q, k, v = (_t(x[n]) for n in "qkv")
    before = (K.swa_flash_fwd.launches, K.swa_flash_bwd.launches)
    with pytest.raises(ValueError, match="head_dim 32"):
        K.swa_flash_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous(), window=8)
    kt = k.transpose(1, 2).contiguous().transpose(1, 2)
    assert not kt.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        K.swa_flash_fwd(q, kt, v, window=8)
    with pytest.raises(ValueError, match="CUDA"):
        K.swa_flash_fwd(q, k, v, window=8)
    o = torch.zeros_like(q)
    lse = torch.zeros(1, 2, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        K.swa_flash_bwd(o, q, k, v, o, lse, window=8)
    with pytest.raises(ValueError, match="shape"):
        K.swa_flash_bwd(o, q, k, v, o, lse[..., :-1], window=8)
    assert (K.swa_flash_fwd.launches, K.swa_flash_bwd.launches) == before


def test_swa_flash_on_cpu_is_the_plain_version_with_grads():
    x = _qkv(1, 96, 2, 2, 16, seed=9)
    before = (K.swa_flash_fwd.launches, K.swa_flash_bwd.launches)
    leaves = [_t(x[n]).requires_grad_(True) for n in "qkv"]
    o = K.swa_flash(*leaves, window=20, causal=True)
    assert torch.equal(o, K.swa_flash_plain(*(t.detach() for t in leaves),
                                            window=20, causal=True))
    grads = torch.autograd.grad(o.square().sum(), leaves)
    assert all(torch.isfinite(g).all() for g in grads)
    assert (K.swa_flash_fwd.launches, K.swa_flash_bwd.launches) == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.swa_flash(*(t.detach().to("meta") for t in leaves), window=20)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_plumbing_with_replayed_kernels(monkeypatch,
                                                          causal, remat):
    """`SWAFlash` with the kernel wrappers replaced by the replays above,
    on CPU tensors: its saved tensors and non-reentrant checkpointing (the
    forward runs again in backward) give the plain version's gradients."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, *, window, causal=True):
        calls["fwd"] += 1
        return replay_forward(q, k, v, window, causal)

    def bwd(do, q, k, v, o, lse, *, window, causal=True):
        calls["bwd"] += 1
        assert do.is_contiguous()
        return replay_backward(do, q, k, v, o, lse, window=window,
                               causal=causal)

    monkeypatch.setattr(K, "swa_flash_fwd", fwd)
    monkeypatch.setattr(K, "swa_flash_bwd", bwd)
    x = _qkv(1, 136, 2, 2, 64, seed=10)
    wo = _t(np.random.default_rng(11).standard_normal((256, 8))
            .astype(np.float32))

    def route(q, k, v):                      # o feeds a projection
        o = K.SWAFlash.apply(q, k, v, 45, causal)
        return (o.reshape(1, 136, 256) @ wo).square().sum()

    leaves = [_t(x[n]).requires_grad_(True) for n in "qkv"]
    if remat:
        from torch.utils.checkpoint import checkpoint
        out = checkpoint(route, *leaves, use_reentrant=False)
    else:
        out = route(*leaves)
    got = torch.autograd.grad(out, leaves)
    assert calls == {"fwd": 2 if remat else 1, "bwd": 1}
    ref = [_t(x[n]).requires_grad_(True) for n in "qkv"]
    o = K.swa_flash_plain(*ref, window=45, causal=causal)
    want = torch.autograd.grad((o.reshape(1, 136, 256) @ wo).square().sum(),
                               ref)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * w.abs().max().item(),
                                   err_msg=name)


def test_resource_report_reads_the_build_log(tmp_path, monkeypatch):
    """`build.resource_report` (what chip_smoke.py prints of the bf16
    kernels' registers and spills) keeps ptxas's entry, spill and
    register lines of the library's build log, and gives [] before a
    build has written one."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    (tmp_path / "k.cu").write_text("// a kernel\n")
    assert build.resource_report("k") == []
    log = build._target(tmp_path / "k.cu").with_suffix(".log")
    log.parent.mkdir()
    log.write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1fv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1fv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n")
    assert build.resource_report("k") == [
        "ptxas info    : Compiling entry function '_Z1fv' for 'sm_90a'",
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers"]
