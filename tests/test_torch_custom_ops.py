"""The kernels' torch.library custom ops (`repro_torch::swa_flash_fwd`,
`swa_flash_bwd`, `ssd_scan_fwd`, `ssd_scan_bwd`): on CPU tensors they give
the plain route's outputs (bit for bit) and its gradients (to fp32
rounding: the backward ops recompute the plain forward and its autograd);
`torch.library.opcheck` passes on each (schema, fake impl, autograd
registration, AOT dispatch); DTensor inputs reach them through the
sharding rules with the same values; nothing launches on the CPU."""
import importlib

import pytest
import torch

from repro_torch.kernels import launch_counts

SW = importlib.import_module("repro_torch.kernels.swa_attention")
SS = importlib.import_module("repro_torch.kernels.ssd_scan")


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1))


def _qkv(B, S, KV, G, hd, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, KV, G, hd, generator=g).to(dtype)
    k = torch.randn(B, S, KV, hd, generator=g).to(dtype)
    v = torch.randn(B, S, KV, hd, generator=g).to(dtype)
    return q, k, v


def _ssd(B, S, H, P, N, seed):
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(B, S, H, P, generator=g)
    a = -torch.rand(B, S, H, generator=g)
    bm = torch.randn(B, S, N, generator=g)
    cm = torch.randn(B, S, N, generator=g)
    h0 = torch.randn(B, H, P, N, generator=g)
    return u, a, bm, cm, h0


SWA_CASES = [(1, 96, 2, 2, 16, 20, True), (2, 64, 1, 3, 32, 1 << 30, True),
             (1, 80, 2, 1, 16, 7, False), (1, 48, 1, 2, 16, 1, True)]


@pytest.mark.parametrize("B,S,KV,G,hd,window,causal", SWA_CASES)
def test_swa_ops_give_the_plain_route(B, S, KV, G, hd, window, causal):
    before = launch_counts()
    q, k, v = _qkv(B, S, KV, G, hd, torch.float32, seed=S)
    o, lse = SW.swa_flash_fwd_op(q, k, v, window, causal)
    assert torch.equal(o, SW.swa_flash(q, k, v, window=window,
                                       causal=causal))
    assert o.is_contiguous() and lse.shape == (B, KV, G, S)
    # lse: the masked rows' log-sum-exp of the scaled scores
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k) * hd ** -0.5
    i = torch.arange(S)
    ok = (i[:, None] - i[None, :] < window) & (i[None, :] - i[:, None]
                                               < window)
    if causal:
        ok &= i[None, :] <= i[:, None]
    want = torch.logsumexp(torch.where(ok, s, torch.tensor(-1e30)), -1)
    assert _rel(lse, want) < 1e-6
    do = torch.randn_like(q)
    got = SW.swa_flash_bwd_op(do, q, k, v, o, lse, window, causal)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(SW.swa_flash(*leaves, window=window,
                                            causal=causal), leaves, do)
    for name, g, w in zip("qkv", got, want):
        assert _rel(g, w) < 2e-6, name
    assert launch_counts() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_swa_ops_pass_opcheck(dtype, causal):
    q, k, v = _qkv(1, 64, 2, 2, 16, dtype, seed=3)
    o, lse = SW.swa_flash_fwd_op(q, k, v, 24, causal)
    torch.library.opcheck(SW.swa_flash_fwd_op, (q, k, v, 24, causal))
    torch.library.opcheck(SW.swa_flash_bwd_op,
                          (torch.randn_like(q), q, k, v, o, lse, 24, causal))


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("with_dh", [True, False])
def test_ssd_ops_give_the_plain_route(with_h0, with_dh):
    before = launch_counts()
    u, a, bm, cm, h0 = _ssd(1, 48, 2, 16, 32, seed=5)
    h0 = h0 if with_h0 else None
    y, hf, hs = SS.ssd_scan_fwd_op(u, a, bm, cm, h0, 16)
    yp, hp = SS.ssd_scan(u, a, bm, cm, h0, chunk=16)
    assert torch.equal(y, yp) and torch.equal(hf, hp)
    assert hs.shape == (1, 2, 3, 16, 32)
    if with_h0:
        assert torch.equal(hs[:, :, 0], h0)
    dy = torch.randn_like(u)
    dh = torch.randn_like(hf) if with_dh else None
    got = SS.ssd_scan_bwd_op(dy, dh, u, a, bm, cm, hs, 16)
    leaves = [t.clone().requires_grad_(True) for t in (u, a, bm, cm)]
    h0_leaf = (h0 if with_h0 else torch.zeros_like(hf)).clone() \
        .requires_grad_(True)
    yy, hh = SS.ssd_scan_plain(*leaves, h0_leaf, chunk=16)
    outs, cots = ([yy, hh], [dy, dh]) if with_dh else ([yy], [dy])
    want = torch.autograd.grad(outs, leaves + [h0_leaf], cots)
    for name, g, w in zip(["du", "da", "dB", "dC", "dh0"], got, want):
        assert _rel(g, w) < 5e-6, name
    assert launch_counts() == before


@pytest.mark.parametrize("with_h0", [True, False])
def test_ssd_ops_pass_opcheck(with_h0):
    u, a, bm, cm, h0 = _ssd(1, 40, 2, 16, 24, seed=7)
    h0 = h0 if with_h0 else None
    y, hf, hs = SS.ssd_scan_fwd_op(u, a, bm, cm, h0, 8)
    torch.library.opcheck(SS.ssd_scan_fwd_op, (u, a, bm, cm, h0, 8))
    for dh in (None, torch.randn_like(hf)):
        torch.library.opcheck(SS.ssd_scan_bwd_op,
                              (torch.randn_like(u), dh, u, a, bm, cm, hs, 8))


def test_ops_refuse_other_devices():
    q, k, v = (t.to("meta") for t in _qkv(1, 8, 1, 1, 16, torch.float32, 0))
    with pytest.raises(ValueError, match="cuda or cpu"):
        SW._fwd_impl(q, k, v, 4, True)
    u, a, bm, cm, _ = (t.to("meta") for t in _ssd(1, 8, 1, 16, 8, 0))
    with pytest.raises(ValueError, match="cuda or cpu"):
        SS._fwd_impl(u, a, bm, cm, None, 8)


def test_dtensor_inputs_take_the_custom_ops():
    """On a (1, 1) mesh of a fake process group (real CPU shards, placed
    as batch shards), the public entries with DTensor inputs go through
    the autograd functions and the custom ops' sharding rules: outputs
    and gradients equal the plain tensors' route."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import make_mesh
    import torch.distributed as dist
    mesh = make_mesh((1, 1), ("data", "model"))
    try:
        q, k, v = _qkv(2, 64, 2, 2, 16, torch.float32, seed=11)
        dq = [DTensor.from_local(t.clone(), mesh, [Shard(0), Replicate()])
              .requires_grad_(True) for t in (q, k, v)]
        o = SW.swa_flash(*dq, window=16, causal=True)
        assert isinstance(o, DTensor)
        want = SW.swa_flash(q, k, v, window=16, causal=True)
        assert torch.equal(o.full_tensor(), want)
        grads = torch.autograd.grad(o.sum(), dq)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = torch.autograd.grad(SW.swa_flash(*leaves, window=16).sum(),
                                  leaves)
        for g, w in zip(grads, ref):
            assert _rel(g.full_tensor(), w) < 2e-6
        u, a, bm, cm, h0 = _ssd(2, 32, 2, 16, 8, seed=13)
        du = [DTensor.from_local(t.clone(), mesh, [Shard(0), Replicate()])
              .requires_grad_(True) for t in (u, a, bm, cm)]
        y, hf = SS.ssd_scan(*du, chunk=8)
        yp, hp = SS.ssd_scan(u, a, bm, cm, chunk=8)
        assert torch.equal(y.full_tensor(), yp)
        assert torch.equal(hf.full_tensor(), hp)
        g = torch.autograd.grad(y.sum(), du)
        leaves = [t.clone().requires_grad_(True) for t in (u, a, bm, cm)]
        ref = torch.autograd.grad(SS.ssd_scan(*leaves, chunk=8)[0].sum(),
                                  leaves)
        for x, w in zip(g, ref):
            assert _rel(x.full_tensor(), w) < 5e-6
    finally:
        dist.destroy_process_group()


def test_plain_cpu_tensors_keep_the_plain_route():
    """A plain CPU tensor never reaches the ops: `swa_flash` and
    `ssd_scan` run their plain versions under autograd, as before; a
    FakeTensor reaches them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.add(func.namespace)
            return func(*args, **(kwargs or {}))

    q, k, v = _qkv(1, 32, 1, 1, 16, torch.float32, seed=1)
    u, a, bm, cm, _ = _ssd(1, 16, 1, 16, 8, seed=2)
    with Seen() as seen:
        SW.swa_flash(q, k, v, window=8)
        SS.ssd_scan(u, a, bm, cm, chunk=8)
    assert "repro_torch" not in seen.ops and "aten" in seen.ops
    with FakeTensorMode() as fm:
        fq, fk, fv = (fm.from_tensor(t) for t in (q, k, v))
        with Seen() as seen:
            o = SW.swa_flash(fq, fk, fv, window=8)
    assert "repro_torch" in seen.ops and o.shape == q.shape
