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
* Replays of the two CUDA kernels' algorithms (csrc/ssd_scan.cu) in plain
  torch loops, ordered as the sources order them: p-tiles with padded
  rows, the saved chunk-boundary states, the backward's sub-segment
  recompute and reverse walk, and its per-(b, h, p-tile) partial sums.
  The kernels run only on the card, so this is where their algebra is
  checked (`_close` against the plain version and its autograd).
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
def _pad_rows(x, rows, axis):
    """Zero-pad axis `axis` (the P axis) to a multiple of `rows`, as the
    kernels mask rows past P."""
    P = x.shape[axis]
    pad = -P % rows
    if not pad:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], axis)


def replay_forward(u, a, Bm, Cm, h0, chunk):
    """ssd_fwd_kernel, all blocks at once: block (b, h, pt) holds rows
    pt*FWD_ROWS.. of the state and walks S in FWD_T-step segments, saving
    the state before each chunk into hs."""
    B, S, H, P = u.shape
    N = Bm.shape[-1]
    Q = K.chunk_len(S, chunk)
    nc = S // Q
    R = K.FWD_ROWS
    n_pt = -(-P // R)
    up = _pad_rows(u, R, 3).reshape(B, S, H, n_pt, R)
    st = (torch.zeros(B, H, n_pt, R, N) if h0 is None
          else _pad_rows(h0, R, 2).reshape(B, H, n_pt, R, N))
    hs = torch.zeros(B, H, nc, n_pt * R, N)
    y = torch.zeros(B, S, H, n_pt * R)
    for t0 in range(0, S, K.FWD_T):
        for i in range(min(K.FWD_T, S - t0)):
            t = t0 + i
            if t % Q == 0:
                hs[:, :, t // Q] = st.reshape(B, H, n_pt * R, N)
            e = torch.exp(a[:, t])[:, :, None, None, None]
            st = e * st + up[:, t][..., None] * Bm[:, t][:, None, None, None]
            y[:, t] = (st * Cm[:, t][:, None, None, None]).sum(-1) \
                .reshape(B, H, n_pt * R)
    return (y[..., :P], st.reshape(B, H, n_pt * R, N)[:, :, :P],
            hs[:, :, :, :P])


def replay_backward(dy, dh_final, u, a, Bm, Cm, hs, chunk):
    """ssd_bwd_kernel, all blocks at once, then the wrapper's partial
    sums. Per chunk (in reverse): pass 1 stores the state before every
    BWD_SUB-step sub-segment into scratch; pass 2 walks the sub-segments
    in reverse, recomputes one's states, walks them back, and sums each
    BWD_RED-step group over the block's rows."""
    B, S, H, P = u.shape
    N = Bm.shape[-1]
    Q = K.chunk_len(S, chunk)
    nc = S // Q
    R, SUB, RED = K.BWD_ROWS, K.BWD_SUB, K.BWD_RED
    n_pt = -(-P // R)
    n_sub = -(-Q // SUB)
    blk = (B, H, n_pt, R)
    up = _pad_rows(u, R, 3).reshape(B, S, H, n_pt, R)
    dyp = _pad_rows(dy, R, 3).reshape(B, S, H, n_pt, R)
    hsp = _pad_rows(hs, R, 3).reshape(B, H, nc, n_pt, R, N)
    g = (torch.zeros(*blk, N) if dh_final is None
         else _pad_rows(dh_final, R, 2).reshape(*blk, N))
    du = torch.zeros(B, S, H, n_pt, R)
    da_part = torch.zeros(B, n_pt, S, H)
    dB_part = torch.zeros(B, H, n_pt, S, N)
    dC_part = torch.zeros(B, H, n_pt, S, N)
    scratch = torch.zeros(B, H, n_pt, n_sub, R, N)

    def step(st, t):
        e = torch.exp(a[:, t])[:, :, None, None, None]
        return e * st + up[:, t][..., None] * Bm[:, t][:, None, None, None]

    for c in reversed(range(nc)):
        c0 = c * Q
        st = hsp[:, :, c]
        for k in range(n_sub):                         # pass 1
            scratch[:, :, :, k] = st
            if k == n_sub - 1:
                break
            for i in range(SUB):
                st = step(st, c0 + k * SUB + i)
        for k in reversed(range(n_sub)):               # pass 2
            t0 = c0 + k * SUB
            T = min(SUB, c0 + Q - t0)
            h_in = scratch[:, :, :, k]
            hist = []
            for i in range(T):
                hist.append(step(hist[-1] if hist else h_in, t0 + i))
            for grp in reversed(range(SUB // RED)):
                rB, rC, rA = {}, {}, {}
                for r in reversed(range(RED)):
                    i = grp * RED + r
                    if i >= T:
                        continue
                    t = t0 + i
                    e = torch.exp(a[:, t])[:, :, None, None]
                    dyv = dyp[:, t]
                    g = g + dyv[..., None] * Cm[:, t][:, None, None, None]
                    du[:, t] = (g * Bm[:, t][:, None, None, None]).sum(-1)
                    prev = hist[i - 1] if i else h_in
                    rA[r] = (g * prev).sum(-1) * e
                    rB[r] = g * up[:, t][..., None]
                    rC[r] = hist[i] * dyv[..., None]
                    g = g * e[..., None]
                for r in range(RED):
                    t = t0 + grp * RED + r
                    if grp * RED + r >= T:
                        continue
                    dB_part[:, :, :, t] = rB[r].sum(3)
                    dC_part[:, :, :, t] = rC[r].sum(3)
                    da_part[:, :, t] = rA[r].sum(3).permute(0, 2, 1)
    du = du.reshape(B, S, H, n_pt * R)[..., :P]
    dh0 = g.reshape(B, H, n_pt * R, N)[:, :, :P]
    return (du, da_part.sum(1), dB_part.reshape(B, H * n_pt, S, N).sum(1),
            dC_part.reshape(B, H * n_pt, S, N).sum(1), dh0)


REPLAY_SHAPES = SHAPES + [
    (1, 60, 2, 24, 40, 12),      # Q not a multiple of BWD_SUB; ragged P, N
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
    # the same recurrence as the port's per-step oracle
    yr, hfr = torch_ssd_scan_ref(u, a, Bm, Cm, h0)
    _close(y.numpy(), yr.numpy())
    _close(hf.numpy(), hfr.numpy())
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
