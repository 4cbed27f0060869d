"""The port's serving path against the JAX package's: prefill
(`logits_fn` and its caches), `init_cache`, `decode_step`,
`attention_decode` and `ssm_decode`, on JAX-initialised weights carried
across by `repro_torch.convert` and the same tokens (numpy, seeded), for
every admitted family that decodes: reduced opt-125m, gemma3-4b
(local and global layers), starcoder2-3b (sliding window), qwen3-8b
(qk-norm) and mamba2-130m, float32.

Tolerance: the reference's own for decode against the forward, atol
2e-4 and rtol 2e-3 (tests/test_models_smoke.py::
test_decode_matches_forward): the same float32 math, summed in another
order. The reference's decode tests are ported onto the port (decode
against the forward, the homogeneous-SWA ring against the full cache,
`ssm_decode` continuity against `ssm_block`), and the ring cache of a
model with global layers is pinned where the port differs from the
reference on purpose (ROADMAP §3)."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.core.treebytes import leaf_arrays, tree_unflatten
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS

ARCHS = ["opt-125m", "gemma3-4b", "starcoder2-3b", "qwen3-8b",
         "mamba2-130m"]
TOL = dict(atol=2e-4, rtol=2e-3)
B, T, SMAX = 2, 12, 16


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(tget(arch).reduced(), **kw))


def _tokens(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


_PARAMS = {}


def _params(arch, cfg):
    """JAX params (PRNGKey 0) and the port's copy, once per arch."""
    if arch not in _PARAMS:
        jp = JM.init_params(cfg, jax.random.PRNGKey(0))
        _PARAMS[arch] = jp, convert.state_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu")
    return _PARAMS[arch]


def _leaves(jtree, ttree):
    """(path, jax leaf as numpy, port leaf as numpy) over the reference's
    tree, the port's looked up by the same keys."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        t = ttree
        for k in path:
            t = t[k.key]
        out.append((jax.tree_util.keystr(path), np.asarray(leaf),
                    t.detach().numpy()))
    return out


def _jax_decode(cfg, params, cache, toks):
    step = jax.jit(lambda p, c, t: JM.decode_step(cfg, p, c, t))
    logits = []
    for t in range(toks.shape[1]):
        lg, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]))
        logits.append(np.asarray(lg))
    return logits, cache


def _port_decode(cfg, params, cache, toks):
    logits = []
    for t in range(toks.shape[1]):
        lg, cache = TM.decode_step(cfg, params, cache,
                                   torch.from_numpy(toks[:, t:t + 1]))
        logits.append(lg.numpy())
    return logits, cache


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_fn_and_caches_match_reference(arch):
    cfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch, cfg)
    toks = _tokens(cfg, (B, T), 5)
    jl, jc = JM.logits_fn(cfg, jp, {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(toks)})
    tl, tc = TM.logits_fn(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(toks)})
    assert tl.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    leaves = _leaves(jc, tc)
    assert len(leaves) == 2
    for path, want, got in leaves:
        assert got.shape == want.shape and got.dtype == want.dtype, path
        np.testing.assert_allclose(got, want, err_msg=path, **TOL)


@pytest.mark.parametrize("window_kv_cache", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch, window_kv_cache):
    """Shapes, dtypes and zeros, leaf for leaf. With `window_kv_cache`
    gemma3's ring differs on purpose (its global layers keep every slot;
    see the pin below), so there only the port's own rule is checked."""
    cfg, tcfg = _cfgs(arch, window_kv_cache=window_kv_cache)
    jc = JM.init_cache(cfg, B, 100)
    tc = TM.init_cache(tcfg, B, 100, "cpu")
    for path, want, got in _leaves(jc, tc):
        assert got.dtype == want.dtype, path
        assert not got.any(), path
        if window_kv_cache and arch == "gemma3-4b" and got.ndim == 5:
            assert got.shape[2] == 100 and want.shape[2] == 64, path
            continue
        assert got.shape == want.shape, path
    if window_kv_cache and arch == "starcoder2-3b":     # the ring: window
        assert tc["entries"]["pos0"]["k"].shape[2] == 64


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """Every step's logits, then every cache leaf and the index after T
    steps, against the reference's decode on the same tokens."""
    cfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch, cfg)
    toks = _tokens(cfg, (B, T), 6)
    jlog, jc = _jax_decode(cfg, jp, JM.init_cache(cfg, B, SMAX), toks)
    tlog, tc = _port_decode(tcfg, tp, TM.init_cache(tcfg, B, SMAX, "cpu"),
                            toks)
    for t, (want, got) in enumerate(zip(jlog, tlog)):
        assert got.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(got, want, err_msg=f"step {t}", **TOL)
    assert int(tc["index"]) == int(jc["index"]) == T
    assert tc["index"].dtype == torch.int32
    for path, want, got in _leaves(jc["entries"], tc["entries"]):
        np.testing.assert_allclose(got, want, err_msg=path, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """tests/test_models_smoke.py::test_decode_matches_forward on the
    port, and the caches decode wrote against the prefill's."""
    _, tcfg = _cfgs(arch)
    _, tp = _params(arch, _cfgs(arch)[0])
    toks = torch.from_numpy(_tokens(tcfg, (B, T), 5))
    lg_full, caches = TM.logits_fn(tcfg, tp, {"tokens": toks,
                                              "labels": toks})
    cache = TM.init_cache(tcfg, B, SMAX, "cpu")
    for t in range(T):
        lg, cache = TM.decode_step(tcfg, tp, cache, toks[:, t:t + 1])
    np.testing.assert_allclose(lg.numpy(), lg_full.numpy(), **TOL)
    assert int(cache["index"]) == T
    got = cache["entries"]["pos0"]
    for name, want in caches["pos0"].items():
        have = got[name][:, :, :T] if name in ("k", "v") else got[name]
        np.testing.assert_allclose(have.numpy(), want.numpy(), err_msg=name,
                                   **TOL)


def test_window_kv_cache_ring_buffer():
    """tests/test_models_smoke.py::test_window_kv_cache_ring_buffer on the
    port: a window-sized ring reproduces full-cache decode (homogeneous
    SWA, window 8, 24 tokens through 8 slots)."""
    _, tcfg = _cfgs("starcoder2-3b", sliding_window=8)
    ring = dataclasses.replace(tcfg, window_kv_cache=True)
    _, tp = _params("starcoder2-3b", _cfgs("starcoder2-3b")[0])
    toks = torch.from_numpy(_tokens(tcfg, (1, 24), 7))
    c_full = TM.init_cache(tcfg, 1, 32, "cpu")
    c_ring = TM.init_cache(ring, 1, 32, "cpu")
    assert c_ring["entries"]["pos0"]["k"].shape[2] == 8 < \
        c_full["entries"]["pos0"]["k"].shape[2]
    for t in range(24):
        lf, c_full = TM.decode_step(tcfg, tp, c_full, toks[:, t:t + 1])
        lr, c_ring = TM.decode_step(ring, tp, c_ring, toks[:, t:t + 1])
        np.testing.assert_allclose(lf.numpy(), lr.numpy(), atol=1e-4,
                                   rtol=1e-3, err_msg=f"step {t}")


def test_window_kv_cache_global_layers_differ_from_reference_on_purpose():
    """Reduced gemma3 (a local and a global layer), window 4, a 32-slot
    cache, 16 tokens, `window_kv_cache=True`. The reference sizes the ring
    by the first layer's window, so its global layer attends only the
    last 4 positions and its decode departs from its own forward by more
    than a tenth of the logit scale. The port keeps every slot where a
    global layer is stacked, and matches its forward and its full-cache
    decode."""
    cfg, tcfg = _cfgs("gemma3-4b", sliding_window=4, window_kv_cache=True)
    full = dataclasses.replace(tcfg, window_kv_cache=False)
    jp, tp = _params("gemma3-4b", _cfgs("gemma3-4b")[0])
    toks = _tokens(cfg, (1, 16), 8)

    jl, _ = JM.logits_fn(cfg, jp, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(toks)})
    jc = JM.init_cache(cfg, 1, 32)
    assert jc["entries"]["pos0"]["k"].shape[2] == 4
    jdec, _ = _jax_decode(cfg, jp, jc, toks)
    scale = np.abs(np.asarray(jl)).max()
    gap = np.abs(jdec[-1] - np.asarray(jl)).max()
    assert gap > 0.1 * scale, (gap, scale)

    tl, _ = TM.logits_fn(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                    "labels": torch.from_numpy(toks)})
    tc = TM.init_cache(tcfg, 1, 32, "cpu")
    assert tc["entries"]["pos0"]["k"].shape[2] == 32
    tdec, _ = _port_decode(tcfg, tp, tc, toks)
    fdec, _ = _port_decode(full, tp, TM.init_cache(full, 1, 32, "cpu"),
                           toks)
    np.testing.assert_allclose(tdec[-1], tl.numpy(), atol=2e-4, rtol=0)
    for t, (a, b) in enumerate(zip(tdec, fdec)):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=0,
                                   err_msg=f"step {t}")


@pytest.mark.parametrize("smax,index,window", [(16, 5, 1 << 30),
                                               (8, 13, 5), (8, 3, 8),
                                               (6, 6, 6)])
def test_attention_decode_matches_reference(smax, index, window):
    """One step on a cache of random contents, at slots before, at and
    past the ring's wrap, with a full window and with sliding ones."""
    cfg, tcfg = _cfgs("qwen3-8b")
    jp, tp = _params("qwen3-8b", cfg)
    p = jax.tree.map(lambda a: a[0], jp["blocks"]["pos0"]["mix"])
    tpl = {k: v[0] for k, v in tp["blocks"]["pos0"]["mix"].items()}
    rng = np.random.default_rng(index)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    shape = (B, smax, cfg.num_kv_heads, cfg.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    jout, jk, jv = JA.attention_decode(p, cfg, jnp.asarray(x),
                                       jnp.asarray(ck), jnp.asarray(cv),
                                       window=window, index=jnp.int32(index))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tout, rk, rv = TA.attention_decode(
        tpl, tcfg, torch.from_numpy(x), tk, tv, window=window,
        index=torch.tensor(index, dtype=torch.int32))
    assert rk is tk and rv is tv                     # written in place
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_ssm_decode_matches_reference():
    """Ten steps of `ssm_decode` from a random state, each output and the
    final conv and h states against the reference's."""
    cfg, tcfg = _cfgs("mamba2-130m")
    p = JS.init_ssm(jax.random.PRNGKey(0), cfg)
    tp = convert.state_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 10, cfg.d_model)).astype(np.float32)
    ch = cfg.d_inner + 2 * cfg.ssm_state
    conv = rng.standard_normal((B, cfg.ssm_conv_width - 1, ch)) \
        .astype(np.float32)
    h = rng.standard_normal((B, cfg.ssm_heads, cfg.ssm_head_dim,
                             cfg.ssm_state)).astype(np.float32)
    jconv, jh = jnp.asarray(conv), jnp.asarray(h)
    tconv, th = torch.from_numpy(conv.copy()), torch.from_numpy(h.copy())
    for t in range(10):
        jy, jconv, jh = JS.ssm_decode(p, cfg, jnp.asarray(x[:, t:t + 1]),
                                      jconv, jh)
        ty, rconv, rh = TS.ssm_decode(tp, tcfg, torch.from_numpy(
            x[:, t:t + 1]), tconv, th)
        assert rconv is tconv and rh is th           # written in place
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   err_msg=f"step {t}", **TOL)
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def test_ssm_block_prefill_then_decode_continuity():
    """tests/test_ssm_attention.py::test_ssm_block_prefill_then_decode_
    continuity on the port: the full-sequence block's outputs and states
    equal feeding the same tokens one by one."""
    cfg, tcfg = _cfgs("mamba2-130m")
    tp = convert.state_from_numpy(
        jax.tree.map(np.asarray, JS.init_ssm(jax.random.PRNGKey(0), cfg)),
        "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32))
    y_full, (conv_full, h_full) = TS.ssm_block(tp, tcfg, x)
    W, ch = cfg.ssm_conv_width, cfg.d_inner + 2 * cfg.ssm_state
    conv = torch.zeros((2, W - 1, ch))
    h = torch.zeros((2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))
    ys = [TS.ssm_decode(tp, tcfg, x[:, t:t + 1], conv, h)[0]
          for t in range(10)]
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(h.numpy(), h_full.numpy(), atol=2e-4)
    np.testing.assert_allclose(conv.numpy(), conv_full.numpy(), atol=2e-4)


def test_forward_collect_cache_equals_logits_fn_caches():
    """`forward(collect_cache=True)` (the reference's `_layer_full` with
    its cache) gives the prefill's caches and the forward's loss."""
    cfg, tcfg = _cfgs("gemma3-4b")
    _, tp = _params("gemma3-4b", cfg)
    toks = torch.from_numpy(_tokens(cfg, (B, T), 9))
    batch = {"tokens": toks, "labels": toks}
    loss, out = TM.forward(tcfg, tp, batch, collect_cache=True)
    assert torch.equal(loss, TM.forward(tcfg, tp, batch)[0])
    _, caches = TM.logits_fn(tcfg, tp, batch)
    for name, want in caches["pos0"].items():
        assert torch.equal(out["cache"]["pos0"][name], want), name


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, want, rows=False):
    d = (got.double() - want.double()).flatten(1 if rows else 0)
    w = want.double().flatten(1 if rows else 0)
    return (d.norm(dim=-1) / w.norm(dim=-1)).max().item()


@pytest.mark.parametrize("arch,layers", [("gemma3-4b", 2),
                                         ("starcoder2-3b", 2),
                                         ("mamba2-130m", 2),
                                         ("mamba2-130m", 24),
                                         ("dbrx-132b", 2),
                                         ("jamba-v0.1-52b", 2)])
def test_bf16_decode_spread_is_within_the_chip_bound(arch, layers):
    """Where `chip_smoke.py`'s decode bound comes from: in bf16, 24
    teacher-forced tokens through `decode_step` against `logits_fn`
    (last logits, each cache leaf), measured in units of the bf16
    prefill's distance from an fp32 prefill of the same weights (reduced
    widths; Mamba2 also at its full depth, where random weights amplify
    rounding layer by layer). The CPU's ratios are 0 for the attention
    models (a bf16 product rounds the same per row whatever the rows;
    dbrx's MoE at 2 layers, its decode check's depth on the card, routes
    its 24 tokens alike in both, drop-free: the reduced capacity factor
    is 16) and 0.84-1.05 for Mamba2 (decode's recurrence and conv step
    round apart from the chunked scan and the full conv); Jamba's decode
    check model (`CHECK_OVERRIDES`: attention with an MLP, then an SSM
    layer with the MoE) has both kinds; the card's bound,
    `DECODE_BF16_K`, is about twice the largest, so these stay below
    two thirds of it."""
    cs = _chip_smoke()
    bound = cs.DECODE_BF16_K
    cfg16 = dataclasses.replace(tget(arch).reduced(), num_layers=layers,
                                dtype="bfloat16", param_dtype="bfloat16",
                                **cs.CHECK_OVERRIDES.get(arch, {}))
    cfg32 = dataclasses.replace(cfg16, dtype="float32",
                                param_dtype="float32")
    p16 = TM.init_params(cfg16, torch.Generator().manual_seed(0), "cpu")
    p32 = tree_unflatten(p16, [t.float() for t in leaf_arrays(p16)])
    toks = torch.from_numpy(_tokens(cfg16, (B, 24), 10))
    l16, c16 = TM.logits_fn(cfg16, p16, {"tokens": toks})
    l32, c32 = TM.logits_fn(cfg32, p32, {"tokens": toks})
    cache = TM.init_cache(cfg16, B, 32, "cpu")
    for t in range(24):
        lg, cache = TM.decode_step(cfg16, p16, cache, toks[:, t:t + 1])
    ratios = {"logits": _rel(lg, l16, True) / _rel(l16, l32, True)}
    for pos, ent in cache["entries"].items():
        for name in ent:
            got = ent[name][:, :, :24] if name in ("k", "v") else ent[name]
            ratios[pos, name] = (_rel(got, c16[pos][name])
                                 / _rel(c16[pos][name], c32[pos][name]))
    print(arch, layers, ratios)
    assert all(r <= bound / 1.5 for r in ratios.values()), ratios


def _bf16x3(t):
    """t as the SSD kernel's bf16x3 products see it: its bf16 head plus
    the bf16 rounding of the rest."""
    hi = t.bfloat16().float()
    return hi + (t - hi).bfloat16().float()


@pytest.mark.parametrize("arch,layers", [("gemma3-4b", 34),
                                         ("starcoder2-3b", 30),
                                         ("mamba2-130m", 24),
                                         ("dbrx-132b", 2),
                                         ("jamba-v0.1-52b", 2)])
def test_fp32_decode_is_within_the_chip_bound(arch, layers, monkeypatch):
    """Where `chip_smoke.py`'s fp32 decode bound comes from: in fp32 at
    full depth (reduced widths), 24 teacher-forced tokens through
    `decode_step` against `logits_fn` (last logits per row, each cache
    leaf), with the prefill's SSD inputs rounded as the card's bf16x3
    kernel rounds them. Attention decodes what its prefill computes (0
    here), as does dbrx's MoE, drop-free at 2 layers (its decode check's
    depth on the card); Mamba2 departs by about 9e-5, and Jamba's decode
    check model (an attention and an SSM layer) by what its SSM layer
    departs. The card's bound, `DECODE_FP32_TOL` (the SSM's for the
    hybrid family), is about ten times that, so these stay below half
    of it."""
    cs = _chip_smoke()
    bound = cs.DECODE_FP32_TOL
    cfg = dataclasses.replace(tget(arch).reduced(), num_layers=layers,
                              dtype="float32", param_dtype="float32",
                              **cs.CHECK_OVERRIDES.get(arch, {}))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(cfg, (B, 24), 11))
    scan = TS.ssd_scan
    monkeypatch.setattr(TS, "ssd_scan", lambda u, a, Bm, Cm, h0=None, *,
                        chunk: scan(_bf16x3(u), a, _bf16x3(Bm), _bf16x3(Cm),
                                    h0, chunk=chunk))
    l32, c32 = TM.logits_fn(cfg, params, {"tokens": toks})
    monkeypatch.setattr(TS, "ssd_scan", scan)
    cache = TM.init_cache(cfg, B, 32, "cpu")
    for t in range(24):
        lg, cache = TM.decode_step(cfg, params, cache, toks[:, t:t + 1])
    dist = {"logits": _rel(lg, l32, True)}
    for pos, ent in cache["entries"].items():
        for name in ent:
            got = ent[name][:, :, :24] if name in ("k", "v") else ent[name]
            dist[pos, name] = _rel(got, c32[pos][name])
    print(arch, layers, dist)
    assert all(d <= bound[cfg.family] / 2 for d in dist.values()), dist
