"""The port's SSD scan against the JAX package, on the CPU.

* `ssd_scan_plain` against JAX `ssd_scan` (the Pallas kernel in interpret
  mode, as tests/test_kernels.py runs it; atol 5e-4, rtol 1e-3, that
  test's tolerance) and against `ssd_chunked` at the same chunk (`_close`:
  rtol 1e-4, atol 1e-5 times the reference's largest magnitude, at least
  1e-5; the same fp32 algorithm, summed in another order).
* Its torch autograd against `jax.vjp` of `ssd_chunked`, for u, a, Bm, Cm
  and h0 under the same cotangents (`_close`). Where the reference's da is
  NaN (exp overflow in its masked upper triangle, see `ssd_scan_plain`),
  da is held against `jax.vjp` of `ssd_scan_ref`, the per-step recurrence
  (`_close` at rtol 1e-3, atol 1e-4: another algorithm).
* Replays of the chunked CUDA kernels (csrc/ssd_scan.cu) in plain torch,
  pass by pass as the source orders them: chunk states, state passing,
  S = C B^T and the chunk scan; then X, the reverse state passing, the
  head-summed dS with the tile-slot sums dw, du and da, dB and dC. The
  kernels run only on the card, so this is where their algebra is
  checked (`_close` against the plain version, its autograd, and JAX's
  `ssd_chunked` and `jax.vjp`). A `route` rounds each product's operands
  as the kernels do (bf16 hi + lo, three products); against the fp64
  plain scan the kernels' route holds phase 3's tolerances, one bf16
  product does not.
* The wrappers' input checks, and `ssd_scan` on CPU tensors.

Why the atol scales with the largest magnitude: XLA's CPU cumsum adds in
fp32 in blocks, torch's accumulates in fp64, and at |cum| ~ 100 the two
round cum[t] some 3e-5 apart. exp(cum[t] - cum[s]) carries that into
every term as a relative error, so an element's error follows the size of
the terms summed into it, not its own size: near-zero outputs of O(100)
terms miss a purely element-wise 1e-5. JAX's own `ssd_scan_ref` and
`ssd_chunked` disagree by the same 2e-6 of max |y| at these shapes.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models.ssm import ssd_chunked, ssd_scan_ref
from repro_torch.models.ssm import ssd_scan_ref as torch_ssd_scan_ref

# the package names the public function `ssd_scan`, as the reference does
K = importlib.import_module("repro_torch.kernels.ssd_scan")

SHAPES = [                      # tests/test_kernels.py's sweep
    (2, 64, 4, 8, 16, 16),
    (1, 256, 2, 64, 128, 128),
    (2, 128, 3, 32, 64, 32),
    (1, 96, 1, 16, 32, 48),      # non-power-of-two chunking
]
# shapes whose inputs overflow exp in the reference's masked triangle
OVERFLOW = {(1, 256, 2, 64, 128, 128)}


def _inputs(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"u": f(B, S, H, P),
            "a": -np.logaddexp(f(B, S, H), 0).astype(np.float32),
            "Bm": f(B, S, N), "Cm": f(B, S, N), "h0": f(B, H, P, N),
            "dy": f(B, S, H, P), "dhf": f(B, H, P, N)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=1e-4, atol=1e-5, err_msg=""):
    """assert_allclose with atol scaled by max(1, max |want|)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * scale, err_msg=err_msg)


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_reference(shape, with_h0):
    B, S, H, P, N, Q = shape
    x = _inputs(B, S, H, P, N)
    h0 = x["h0"] if with_h0 else None
    y, hf = K.ssd_scan_plain(_t(x["u"]), _t(x["a"]), _t(x["Bm"]),
                             _t(x["Cm"]), None if h0 is None else _t(h0),
                             chunk=Q)
    jh0 = None if h0 is None else jnp.asarray(h0)
    yk, hk = jax_ssd_scan(jnp.asarray(x["u"]), jnp.asarray(x["a"]),
                          jnp.asarray(x["Bm"]), jnp.asarray(x["Cm"]), jh0,
                          chunk=Q)
    np.testing.assert_allclose(y.numpy(), np.asarray(yk), atol=5e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(hf.numpy(), np.asarray(hk), atol=5e-4,
                               rtol=1e-3)
    yc, hc = ssd_chunked(jnp.asarray(x["u"]), jnp.asarray(x["a"]),
                         jnp.asarray(x["Bm"]), jnp.asarray(x["Cm"]), jh0,
                         chunk=Q)
    _close(y.numpy(), yc)
    _close(hf.numpy(), hc)


def _torch_grads(x, Q, with_h0):
    """Autograd through `ssd_scan_plain` under x's cotangents."""
    names = ["u", "a", "Bm", "Cm"] + (["h0"] if with_h0 else [])
    leaves = {k: _t(x[k]).requires_grad_(True) for k in names}
    y, hf = K.ssd_scan_plain(leaves["u"], leaves["a"], leaves["Bm"],
                             leaves["Cm"], leaves.get("h0"), chunk=Q)
    grads = torch.autograd.grad((y, hf), [leaves[k] for k in names],
                                (_t(x["dy"]), _t(x["dhf"])))
    return {k: g.numpy() for k, g in zip(names, grads)}


def _jax_grads(fn, x, with_h0):
    names = ["u", "a", "Bm", "Cm"] + (["h0"] if with_h0 else [])
    args = [jnp.asarray(x[k]) for k in names]
    if with_h0:
        out, vjp = jax.vjp(fn, *args)
    else:
        out, vjp = jax.vjp(lambda *a: fn(*a, None), *args)
    cts = vjp((jnp.asarray(x["dy"]), jnp.asarray(x["dhf"])))
    return {k: np.asarray(g) for k, g in zip(names, cts)}


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_grads_match_jax_vjp(shape, with_h0):
    B, S, H, P, N, Q = shape
    x = _inputs(B, S, H, P, N, seed=1)
    got = _torch_grads(x, Q, with_h0)
    want = _jax_grads(lambda u, a, b, c, h0: ssd_chunked(u, a, b, c, h0,
                                                         chunk=Q),
                      x, with_h0)
    for k in got:
        if k == "a" and shape in OVERFLOW:
            assert not np.isfinite(want[k]).all()    # the reference's NaN
            ref = _jax_grads(lambda u, a, b, c, h0: ssd_scan_ref(u, a, b, c,
                                                                 h0),
                             x, with_h0)[k]
            assert np.isfinite(got[k]).all()
            _close(got[k], ref, rtol=1e-3, atol=1e-4, err_msg=k)
            continue
        _close(got[k], want[k], err_msg=k)


# ----------------------------------------------- replays of the CUDA kernels
# csrc/ssd_scan.cu multiplies every product with mma.sync in bf16, each fp32
# operand split into hi + lo (hi*hi + hi*lo + lo*hi). `_mm` rounds operands
# at the same points: route "fp32" (no rounding: the algebra alone),
# "bf16x3" (the kernels' split), "bf16" (one product of the rounded
# operands), "tf32x3" and "tf32" (the same with TF32's 10 mantissa bits).
ROUTES = ("fp32", "bf16x3", "bf16", "tf32x3", "tf32")
_BITS = {"bf16": 7, "tf32": 10}


def _round(x, bits):
    """x (fp32) rounded to `bits` mantissa bits, to nearest even, on its
    int32 view: bf16 (__float2bfloat16_rn) keeps 7, tf32 10."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32).to(torch.int64)
    i = (i + (1 << (drop - 1)) - 1 + ((i >> drop) & 1)) & ~((1 << drop) - 1)
    return i.to(torch.int32).view(torch.float32)


def _mm(a, b, route):
    """a @ b (batched) as the kernels multiply under `route`."""
    if route == "fp32":
        return a @ b
    bits = _BITS[route[:4]]
    ah, bh = _round(a, bits), _round(b, bits)
    if not route.endswith("x3"):
        return ah @ bh
    al, bl = _round(a - ah, bits), _round(b - bh, bits)
    return al @ bh + ah @ bl + ah @ bh


def _decay(cum):
    """L[b,c,h,t,s] = e^{cum_t - cum_s} for s <= t, else 0; the mask comes
    before the exponential (`decay` in the source)."""
    c = cum.permute(0, 1, 3, 2)                            # (B,nc,H,Q)
    Q = c.shape[-1]
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    rel = c[..., :, None] - c[..., None, :]
    return torch.exp(torch.where(tri, rel, torch.full_like(rel, -np.inf)))


def _state_pass(buf, A, init, reverse):
    """state_pass_kernel: buf (B,nc,H,P,N) -> (B,H,nc,P,N) of the values
    before each step (forward: the state before chunk c; reverse: the
    cotangent of the state after chunk c), and the last value."""
    nc = buf.shape[1]
    x = torch.zeros_like(buf[:, 0]) if init is None else init
    out = [None] * nc
    for c in (reversed(range(nc)) if reverse else range(nc)):
        out[c] = x
        x = x * torch.exp(A[:, c])[..., None, None] + buf[:, c]
    return torch.stack(out, 2), x


def _tile_sums(W, tile):
    """ds_kernel's dw: for each tile (ti, sj), sj <= ti, of the (Q, Q)
    matrices W, row sums at slot sj (rows of tile ti), minus column sums
    at slot ti (columns of tile sj), rows minus columns at slot ti on the
    diagonal. -> (..., nt, Q), every entry written exactly once."""
    Q = W.shape[-1]
    nt = -(-Q // tile)
    dw = torch.full((*W.shape[:-2], nt, Q), np.nan, dtype=W.dtype)
    span = [slice(i * tile, min(Q, (i + 1) * tile)) for i in range(nt)]
    for ti in range(nt):
        for sj in range(ti + 1):
            blk = W[..., span[ti], span[sj]]
            rows, cols = blk.sum(-1), blk.sum(-2)
            if ti == sj:
                dw[..., ti, span[ti]] = rows - cols
            else:
                dw[..., sj, span[ti]] = rows
                dw[..., ti, span[sj]] = -cols
    assert not torch.isnan(dw).any()
    return dw


def _chunked(u, a, Bm, Cm, chunk):
    B, S, H, P = u.shape
    N = Bm.shape[-1]
    Q = K.chunk_len(S, chunk)
    nc = S // Q
    cum = torch.cumsum(a.reshape(B, nc, Q, H), 2)         # block_scan
    return (B, S, H, P, N, Q, nc, cum, u.reshape(B, nc, Q, H, P),
            Bm.reshape(B, nc, Q, N), Cm.reshape(B, nc, Q, N))


def replay_forward(u, a, Bm, Cm, h0, chunk, route="fp32"):
    """The forward kernels in plain torch, in the source's order: chunk
    states, state passing, S = C B^T, chunk scan. -> (y, h_final, hs)."""
    B, S, H, P, N, Q, nc, cum, uc, Bc, Cc = _chunked(u, a, Bm, Cm, chunk)
    A = cum[:, :, -1]                                      # (B,nc,H)
    # 1. chunk states (w o u)^T B, w = e^{cum_{Q-1} - cum}
    w = torch.exp(A[:, :, None] - cum)
    st = _mm((w[..., None] * uc).permute(0, 1, 3, 4, 2), Bc[:, :, None],
             route)                                        # (B,nc,H,P,N)
    # 2. state passing
    hs, h_final = _state_pass(st, A, h0, reverse=False)
    # 3. S = C B^T, then y = (S o L) u + e^{cum} C hs^T
    Sm = _mm(Cc, Bc.transpose(-1, -2), route)              # (B,nc,Q,Q)
    G = Sm[:, :, None] * _decay(cum)                       # (B,nc,H,Q,Q)
    y = _mm(G, uc.permute(0, 1, 3, 2, 4), route)           # (B,nc,H,Q,P)
    eC = torch.exp(cum).permute(0, 1, 3, 2)[..., None] * Cc[:, :, None]
    y = y + _mm(eC, hs.permute(0, 2, 1, 4, 3), route)
    return y.permute(0, 1, 3, 2, 4).reshape(B, S, H, P), h_final, hs


def replay_backward(dy, dh_final, u, a, Bm, Cm, hs, chunk, route="fp32"):
    """The backward kernels in plain torch, in the source's order: X per
    chunk, the reverse state passing, S with the head-summed dS and the
    tile sums dw, du and da per (chunk, head), dB and dC.
    -> (du, da, dBm, dCm, dh0)."""
    B, S, H, P, N, Q, nc, cum, uc, Bc, Cc = _chunked(u, a, Bm, Cm, chunk)
    A = cum[:, :, -1]
    dyc = dy.reshape(B, nc, Q, H, P)
    dy_h = dyc.permute(0, 1, 3, 2, 4)                      # (B,nc,H,Q,P)
    u_h = uc.permute(0, 1, 3, 2, 4)
    # 1. X = (e^{cum} o dy)^T C
    ec = torch.exp(cum)                                    # (B,nc,Q,H)
    X = _mm((ec[..., None] * dyc).permute(0, 1, 3, 4, 2), Cc[:, :, None],
            route)
    # 2. reverse state passing: gs[c] = d(state after chunk c); dh0
    gs, dh0 = _state_pass(X, A, dh_final, reverse=True)
    hs_c, gs_c = hs.permute(0, 2, 1, 3, 4), gs.permute(0, 2, 1, 3, 4)
    # 3. S, dS = sum_h dG_h o L_h, and dw from W_h = dG_h o S o L_h
    Sm = _mm(Cc, Bc.transpose(-1, -2), route)
    L = _decay(cum)
    dG = _mm(dy_h, u_h.transpose(-1, -2), route)           # (B,nc,H,Q,Q)
    dS = (dG * L).sum(2)
    dcum = _tile_sums(dG * Sm[:, :, None] * L, K.TILE).sum(3)  # (B,nc,H,Q)
    # 4. du = e^{A - cum} B gs^T + (S o L)^T dy; dcum; da
    dec = torch.exp(A[:, :, None] - cum).permute(0, 1, 3, 2)  # (B,nc,H,Q)
    du_state = _mm(dec[..., None] * Bc[:, :, None], gs_c.transpose(-1, -2),
                   route)                                  # (B,nc,H,Q,P)
    z = (u_h * du_state).sum(-1)
    du = du_state + _mm((Sm[:, :, None] * L).transpose(-1, -2), dy_h, route)
    D = _mm(dy_h, hs_c, route)                             # (B,nc,H,Q,N)
    dcum = dcum + ec.permute(0, 1, 3, 2) * (Cc[:, :, None] * D).sum(-1) - z
    dcum[..., -1] += torch.exp(A) * (gs_c * hs_c).sum((-1, -2)) + z.sum(-1)
    da = dcum.flip(-1).cumsum(-1).flip(-1)
    # 5. dC = dS B + sum_h (e^{cum} o dy_h) hs_h, dB = dS^T C + sum_h
    #    (e^{A - cum} o u_h) gs_h, the head sums as one product, K = H * P
    dC = _mm(dS, Bc, route) + _mm(
        (ec[..., None] * dyc).reshape(B, nc, Q, H * P),
        hs_c.reshape(B, nc, H * P, N), route)
    dB = _mm(dS.transpose(-1, -2), Cc, route) + _mm(
        (dec.permute(0, 1, 3, 2)[..., None] * uc).reshape(B, nc, Q, H * P),
        gs_c.reshape(B, nc, H * P, N), route)
    return (du.permute(0, 1, 3, 2, 4).reshape(B, S, H, P),
            da.permute(0, 1, 3, 2).reshape(B, S, H), dB.reshape(B, S, N),
            dC.reshape(B, S, N), dh0)


REPLAY_SHAPES = SHAPES + [
    (1, 60, 2, 24, 40, 12),      # ragged P, N; Q below a tile
    (1, 400, 2, 72, 80, 200),    # 4 row tiles (the last ragged), 2 p and n tiles
]


@pytest.mark.parametrize("shape", REPLAY_SHAPES)
def test_kernel_algorithms_replayed_match_plain(shape):
    B, S, H, P, N, Q = shape
    x = _inputs(B, S, H, P, N, seed=2)
    u, a, Bm, Cm, h0 = (_t(x[k]) for k in ("u", "a", "Bm", "Cm", "h0"))
    y, hf, hs = replay_forward(u, a, Bm, Cm, h0, Q)
    yp, hfp = K.ssd_scan_plain(u, a, Bm, Cm, h0, chunk=Q)
    _close(y.numpy(), yp.numpy())
    _close(hf.numpy(), hfp.numpy())
    # the same recurrence as the port's per-step oracle, and the reference
    yr, hfr = torch_ssd_scan_ref(u, a, Bm, Cm, h0)
    _close(y.numpy(), yr.numpy())
    _close(hf.numpy(), hfr.numpy())
    yc, hc = ssd_chunked(*(jnp.asarray(x[k]) for k in ("u", "a", "Bm", "Cm",
                                                       "h0")), chunk=Q)
    _close(y.numpy(), yc)
    _close(hf.numpy(), hc)
    # hs[c] is the state before chunk c: the plain scan of the prefix
    for c in range(1, S // Q):
        _, h_prefix = K.ssd_scan_plain(u[:, :c * Q].contiguous(),
                                       a[:, :c * Q].contiguous(),
                                       Bm[:, :c * Q].contiguous(),
                                       Cm[:, :c * Q].contiguous(), h0,
                                       chunk=Q)
        _close(hs[:, :, c].numpy(), h_prefix.numpy())
    got = replay_backward(_t(x["dy"]), _t(x["dhf"]), u, a, Bm, Cm, hs, Q)
    want = _torch_grads(x, Q, True)
    for name, g in zip(("u", "a", "Bm", "Cm", "h0"), got):
        _close(g.numpy(), want[name], err_msg=name)
    ref = _jax_grads(lambda u, a, b, c, h0: ssd_chunked(u, a, b, c, h0,
                                                        chunk=Q), x, True)
    for name, g in zip(("u", "a", "Bm", "Cm", "h0"), got):
        if name == "a" and not np.isfinite(ref[name]).all():
            continue       # the reference's NaN (see test_plain_grads_...)
        _close(g.numpy(), ref[name], err_msg=name)


def test_replayed_backward_without_dh_final():
    """The kernel takes a null dh_final (h_final unused) as zero."""
    B, S, H, P, N, Q = 1, 48, 2, 16, 32, 16
    x = _inputs(B, S, H, P, N, seed=3)
    x["dhf"] = np.zeros_like(x["dhf"])
    u, a, Bm, Cm = (_t(x[k]) for k in ("u", "a", "Bm", "Cm"))
    _, _, hs = replay_forward(u, a, Bm, Cm, None, Q)
    got = replay_backward(_t(x["dy"]), None, u, a, Bm, Cm, hs, Q)
    want = _torch_grads(x, Q, False)
    for name, g in zip(("u", "a", "Bm", "Cm"), got):
        _close(g.numpy(), want[name], err_msg=name)


def test_rounding_emulation():
    """_round is round-to-nearest-even at bf16 and tf32 widths."""
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    x = torch.cat([x, torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, -1 - 2 ** -8,
                                    1 + 2 ** -11, 0.0])])
    assert torch.equal(_round(x, 7), x.to(torch.bfloat16).float())
    r = _round(x, 10)
    assert torch.equal(r[-5:], torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8,
                                             -1 - 2 ** -8, 1.0, 0.0]))
    assert ((r - x).abs() <= x.abs() * 2 ** -11).all()
    hi = _round(x, 7)
    lo = _round(x - hi, 7)
    assert ((hi + lo - x).abs() <= x.abs() * 2 ** -16).all()


def _path_inputs(B, S, H, P, N, seed):
    """SSD inputs as mamba2's ssm_block makes them (chip_smoke.py's
    `_ssd_inputs`): a = dt A, u = x dt, A in [-16, -1], dt log-uniform in
    [1e-3, 1e-1] per head times lognormal noise per step; x, B, C, h0 and
    the cotangents standard normal."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    A = -rng.uniform(1.0, 16.0, H)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), H)
                + 0.5 * rng.standard_normal((B, S, H)))
    return {"u": (f(B, S, H, P) * dt[..., None]).astype(np.float32),
            "a": (dt * A).astype(np.float32), "Bm": f(B, S, N),
            "Cm": f(B, S, N), "h0": f(B, H, P, N), "dy": f(B, S, H, P),
            "dhf": f(B, H, P, N)}


def _route_errors(x, Q, route):
    """The replayed kernels under `route` against the fp64 plain scan and
    its autograd: y and h_final as allclose(atol 5e-4, rtol 1e-3) sees them
    (max of |diff| / (5e-4 + 1e-3 |ref|): <= 1 holds), each gradient as max
    |diff| / (1e-3 max |ref|). -> {name: ratio}."""
    names = ["u", "a", "Bm", "Cm", "h0"]
    leaves = [_t(x[k]).double().requires_grad_(True) for k in names]
    y64, hf64 = K.ssd_scan_plain(*leaves, chunk=Q)
    g64 = torch.autograd.grad((y64, hf64), leaves, (_t(x["dy"]).double(),
                                                    _t(x["dhf"]).double()))
    u, a, Bm, Cm, h0 = (_t(x[k]) for k in names)
    y, hf, hs = replay_forward(u, a, Bm, Cm, h0, Q, route)
    grads = replay_backward(_t(x["dy"]), _t(x["dhf"]), u, a, Bm, Cm, hs, Q,
                            route)
    out = {}
    for name, got, want in (("y", y, y64), ("h_final", hf, hf64)):
        want = want.detach()
        out[name] = ((got.double() - want).abs()
                     / (5e-4 + 1e-3 * want.abs())).max().item()
    for name, got, want in zip(names, grads, g64):
        out["d" + name] = ((got.double() - want).abs().max()
                           / (1e-3 * want.abs().max())).item()
    return out


SPLIT_CASES = [  # (inputs, B, S, H, P, N, Q): the main path's widths, cut
    ("path", 1, 512, 2, 64, 128, 256),
    ("randn", 1, 512, 2, 64, 128, 256),
    ("path", 2, 120, 3, 24, 40, 12),
]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_route_holds_the_contract_against_fp64(case):
    """The kernels' bf16x3 split, replayed, within phase 3's tolerances of
    the fp64 plain scan (<= 1 on every ratio), as the fp32 algebra is; one
    bf16 product (the split's cross terms dropped) misses them. Run with -s
    for every route's worst ratio (the prediction in PERF.md): y's is the
    largest, where sums of terms of order 1 cancel to near zero."""
    kind, B, S, H, P, N, Q = case
    x = (_path_inputs if kind == "path" else _inputs)(B, S, H, P, N, seed=6)
    worst = {}
    for route in ROUTES:
        err = _route_errors(x, Q, route)
        worst[route] = max(err.values())
        print(f"{case} {route}: worst {worst[route]:.3e} "
              + " ".join(f"{k} {v:.2e}" for k, v in err.items()))
    assert worst["fp32"] <= 1 and worst["bf16x3"] <= 1
    assert worst["bf16"] > 1


def test_geometry_constants_match_the_cuda_source():
    """ssd_scan.py's TILE, THREADS and MAX_Q are the source's #defines."""
    import re
    from pathlib import Path
    src = (Path(K.__file__).parent / "csrc" / "ssd_scan.cu").read_text()
    d = {m[0]: int(m[1]) for m in re.findall(r"#define (\w+) (\d+)", src)}
    assert (d["TILE"], d["THREADS"], d["MAX_Q"]) == (K.TILE, K.THREADS,
                                                     K.MAX_Q)
    assert d["THREADS"] == 4 * 32 and K.TILE == 16 * 4   # 4 warps x 16 rows


# ---------------------------------------------------------------- wrappers
def _cpu_args(B=1, S=32, H=2, P=8, N=16):
    x = _inputs(B, S, H, P, N, seed=4)
    return [_t(x[k]) for k in ("u", "a", "Bm", "Cm", "h0")]


@pytest.mark.parametrize("fn", ["ssd_scan", "ssd_scan_fwd"])
def test_wrappers_reject_bad_inputs(fn):
    call = (lambda *a: K.ssd_scan(*a, chunk=16)) if fn == "ssd_scan" \
        else (lambda *a: K.ssd_scan_fwd(*a, chunk=16))
    u, a, Bm, Cm, h0 = _cpu_args()
    with pytest.raises(TypeError, match="float32"):
        call(u.double(), a, Bm, Cm, h0)
    with pytest.raises(TypeError, match="float32"):
        call(u, a, Bm.to(torch.bfloat16), Cm, h0)
    with pytest.raises(ValueError, match="rank"):
        call(u[0], a, Bm, Cm, h0)
    with pytest.raises(ValueError, match="contiguous"):
        call(u, a, Bm, Cm.transpose(1, 2).contiguous().transpose(1, 2), h0)
    with pytest.raises(ValueError, match="shape"):
        call(u, a[:, :-1].contiguous(), Bm, Cm, h0)
    with pytest.raises(ValueError, match="shape"):
        call(u, a, Bm, Cm, h0[..., :-1].contiguous())


def test_kernel_wrappers_refuse_cpu_tensors():
    u, a, Bm, Cm, h0 = _cpu_args()
    before = (K.ssd_scan_fwd.launches, K.ssd_scan_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        K.ssd_scan_fwd(u, a, Bm, Cm, h0, chunk=16)
    with pytest.raises(ValueError, match="CUDA"):
        K.ssd_scan_bwd(torch.zeros_like(u), None, u, a, Bm, Cm,
                       torch.zeros(1, 2, 2, 8, 16), chunk=16)
    assert (K.ssd_scan_fwd.launches, K.ssd_scan_bwd.launches) == before


@pytest.mark.parametrize("fn", ["ssd_scan_fwd", "ssd_scan_bwd"])
def test_kernel_wrappers_refuse_chunks_above_max_q(fn):
    """The backward keeps a chunk's dcum in shared memory: Q <= MAX_Q."""
    S = 2 * K.MAX_Q
    x = _inputs(1, S, 1, 1, 1, seed=8)
    u, a, Bm, Cm = (_t(x[k]) for k in ("u", "a", "Bm", "Cm"))
    with pytest.raises(ValueError, match="chunk length"):
        if fn == "ssd_scan_fwd":
            K.ssd_scan_fwd(u, a, Bm, Cm, chunk=S)
        else:
            K.ssd_scan_bwd(torch.zeros_like(u), None, u, a, Bm, Cm,
                           torch.zeros(1, 1, 1, 1, 1), chunk=S)
    with pytest.raises(ValueError, match="CUDA"):   # at MAX_Q it is CUDA's
        K.ssd_scan_fwd(u, a, Bm, Cm, chunk=K.MAX_Q)


def test_ssd_scan_on_cpu_is_the_plain_version_with_grads():
    u, a, Bm, Cm, h0 = _cpu_args()
    before = (K.ssd_scan_fwd.launches, K.ssd_scan_bwd.launches)
    leaves = [t.clone().requires_grad_(True) for t in (u, a, Bm, Cm, h0)]
    y, hf = K.ssd_scan(*leaves, chunk=16)
    yp, hfp = K.ssd_scan_plain(u, a, Bm, Cm, h0, chunk=16)
    assert torch.equal(y, yp) and torch.equal(hf, hfp)
    grads = torch.autograd.grad((y.square().sum() + hf.sum()), leaves)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert (K.ssd_scan_fwd.launches, K.ssd_scan_bwd.launches) == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.ssd_scan(*(t.to("meta") for t in (u, a, Bm, Cm, h0)), chunk=16)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("with_h0", [True, False])
def test_autograd_function_plumbing_with_replayed_kernels(monkeypatch,
                                                          with_h0, remat):
    """`SSDScan` with the kernel wrappers replaced by the replays above, on
    CPU tensors: its saved tensors, None cotangents, the h0=None case and
    non-reentrant checkpointing (the forward runs again in backward) give
    the plain version's gradients."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(u, a, Bm, Cm, h0=None, *, chunk):
        calls["fwd"] += 1
        y, hf, hs = replay_forward(u, a, Bm, Cm, h0, chunk)
        return y, hf, hs.contiguous()

    def bwd(dy, dh_final, u, a, Bm, Cm, hs, *, chunk):
        calls["bwd"] += 1
        return replay_backward(dy, dh_final, u, a, Bm, Cm, hs, chunk)

    monkeypatch.setattr(K, "ssd_scan_fwd", fwd)
    monkeypatch.setattr(K, "ssd_scan_bwd", bwd)
    B, S, H, P, N, Q = 1, 48, 2, 16, 32, 16
    x = _inputs(B, S, H, P, N, seed=5)
    names = ["u", "a", "Bm", "Cm"] + (["h0"] if with_h0 else [])

    def loss(apply, *leaves):
        h0 = leaves[4] if with_h0 else None
        y, hf = apply(*leaves[:4], h0)
        return (y * _t(x["dy"])).sum()           # h_final unused: None

    def kernel_route(*leaves):
        return loss(lambda *a: K.SSDScan.apply(*a, Q), *leaves)

    leaves = [_t(x[k]).requires_grad_(True) for k in names]
    if remat:
        from torch.utils.checkpoint import checkpoint
        out = checkpoint(kernel_route, *leaves, use_reentrant=False)
    else:
        out = kernel_route(*leaves)
    got = torch.autograd.grad(out, leaves)
    assert calls == {"fwd": 2 if remat else 1, "bwd": 1}
    ref_leaves = [_t(x[k]).requires_grad_(True) for k in names]
    want = torch.autograd.grad(
        loss(lambda *a: K.ssd_scan_plain(*a, chunk=Q), *ref_leaves),
        ref_leaves)
    for name, g, w in zip(names, got, want):
        _close(g.numpy(), w.numpy(), err_msg=name)
