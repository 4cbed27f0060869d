"""The port's mixture of experts (`repro_torch.models.moe` and the MoE
family in `models.model`) against the JAX package's, on the CPU, on
JAX-initialised weights carried across by `repro_torch.convert` and the
same inputs (numpy, seeded), float32 unless stated.

Tolerances:
  * `moe_ffn`: atol 2e-4, rtol 1e-3 (`tests/test_moe.py`'s, the
    reference's own against its oracle); the aux loss rtol 1e-6;
  * gradients of `moe_ffn` (the router's and every expert leaf's) and
    the capacity-padded forward: within 1e-5 of each leaf's largest
    magnitude (the expert outputs reach ~1e3 at these widths, so an
    element cancelling to ~0 keeps the float32 noise of its terms);
  * the model's loss rtol 1e-5, its aux rtol 1e-5, every gradient rtol
    1e-4 and atol 1e-5 of its leaf's largest magnitude (the dense
    models' atol of 1e-6 is an absolute one: here the experts' outputs,
    ~1e3 at the reduced widths, carry their float32 noise into the
    embedding's gradient, 2.3e-6 at most on a leaf of scale 1.4);
  * `logits_fn`, its caches and `decode_step` atol 2e-4, rtol 2e-3
    (`tests/test_torch_decode.py`'s); decode against the prefill at a
    drop-free capacity the same;
  * byte streams, restores, touched masks and dirty ranges: exact.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.configs.base import InputShape as JaxShape
from repro.core import delta as jdelta
from repro.core import treebytes as jtb
from repro.core.coordinator import ReftGroup as JaxGroup
from repro.core.recovery import restore_from_checkpoint as jax_restore_ckpt
from repro.core.snapshot import ReftConfig as JaxConfig
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.train.steps import init_train_state as jax_init_train_state
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import InputShape
from repro_torch.core import delta as tdelta
from repro_torch.core import treebytes as ttb
from repro_torch.core.coordinator import ReftGroup
from repro_torch.core.recovery import restore_from_checkpoint, restore_state
from repro_torch.core.snapshot import ReftConfig
from repro_torch.core.treebytes import leaf_arrays, tree_flatten_with_path
from repro_torch.data.pipeline import make_batch
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.train import steps as tsteps

DBRX, KIMI = "dbrx-132b", "kimi-k2-1t-a32b"
TOL = dict(atol=2e-4, rtol=2e-3)


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(tget(arch).reduced(), **kw))


def _jax_moe(cfg):
    return jax.jit(lambda p, x: JMoE.moe_ffn(p, cfg, x))


def _moe_inputs(cfg, shape, key=0, seed=1):
    p = JMoE.init_moe(jax.random.PRNGKey(key), cfg)
    x = np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)
    tp = convert.state_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    return p, x, tp


def _close_to_scale(got, want, rel=1e-5, what=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


# ------------------------------------------------------------- moe_ffn
@pytest.mark.parametrize("arch,over,shape", [
    (DBRX, {"capacity_factor": 8.0}, (2, 6)),        # drop-free
    (DBRX, {"capacity_factor": 0.5}, (2, 6)),        # heavy drop
    (KIMI, {"num_experts": 4, "experts_per_token": 1,
            "capacity_factor": 8.0}, (1, 8)),        # top-1
], ids=["dbrx-cf8", "dbrx-cf0.5", "kimi-top1"])
def test_moe_ffn_matches_reference(arch, over, shape):
    cfg, tcfg = _cfgs(arch, **over)
    p, x, tp = _moe_inputs(cfg, shape)
    y, aux = _jax_moe(cfg)(p, jnp.asarray(x))
    ty, taux = TMoE.moe_ffn(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-6)
    assert float(taux) > 0


def test_capacity_and_its_padding_match_reference():
    """`_capacity` on a grid of shapes, and `moe_pad_capacity`: the padded
    forward (C + 1 rounded up to 16: 20 -> 31 slots for 80 tokens at
    factor 0.5, so fewer drop) equals the reference's."""
    for T in (1, 7, 40, 4096, 32768):
        for k, E, f in ((2, 4, 4.0), (4, 16, 1.25), (8, 384, 1.0),
                        (1, 4, 0.5)):
            assert TMoE._capacity(T, k, E, f) == JMoE._capacity(T, k, E, f)
    cfg, tcfg = _cfgs(DBRX, capacity_factor=0.5, moe_pad_capacity=16)
    p, x, tp = _moe_inputs(cfg, (2, 40))
    y, aux = _jax_moe(cfg)(p, jnp.asarray(x))
    ty, taux = TMoE.moe_ffn(tp, tcfg, torch.from_numpy(x))
    _close_to_scale(ty.numpy(), y)
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-6)
    # the padding changes C and so the drops: not the identity
    unpadded = TMoE.moe_ffn(tp, dataclasses.replace(tcfg, moe_pad_capacity=0),
                            torch.from_numpy(x))[0]
    assert not torch.equal(ty, unpadded)


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_ffn_grads_match_reference(cf):
    """sum(y * r) + 0.01 aux: the router's gradient, every expert leaf's
    and the input's against `jax.grad`."""
    cfg, tcfg = _cfgs(DBRX, capacity_factor=cf)
    p, x, tp = _moe_inputs(cfg, (2, 6))
    r = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def loss(p, x):
        y, aux = JMoE.moe_ffn(p, cfg, x)
        return jnp.sum(y * r) + 0.01 * aux

    jg, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, jnp.asarray(x))
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    ty, taux = TMoE.moe_ffn(leaves, tcfg, xt)
    tg = torch.autograd.grad((ty * torch.from_numpy(r)).sum() + 0.01 * taux,
                             [*leaves.values(), xt])
    for (name, _), g in zip(leaves.items(), tg):
        assert float(np.abs(np.asarray(jg[name])).max()) > 0, name
        _close_to_scale(g.numpy(), jg[name], what=name)
    _close_to_scale(tg[-1].numpy(), jgx, what="x")


def test_dispatch_is_a_pure_gather():
    """The combine and the dispatch's gradient are gathers summed over a
    fixed axis: two runs give the same bits, and the input's gradient
    from the drop-free dispatch equals the plain autograd of `x[idx]`
    (index_add_) on the same slots."""
    _, tcfg = _cfgs(DBRX)
    _, x, tp = _moe_inputs(tcfg, (2, 6))
    outs = []
    for _ in range(2):
        xt = torch.from_numpy(x).requires_grad_(True)
        y, _ = TMoE.moe_ffn(tp, tcfg, xt)
        outs.append((y, torch.autograd.grad(y.square().sum(), xt)[0]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    xf = torch.from_numpy(x).reshape(12, -1)
    sel = torch.tensor(np.random.default_rng(4).integers(0, 4, (12, 2)))
    disp, slot, _ = TMoE._plan(sel, 4, 6)
    a = xf.clone().requires_grad_(True)
    b = xf.clone().requires_grad_(True)
    g = torch.randn(4 * 7, xf.shape[1], generator=torch.Generator()
                    .manual_seed(0))
    ga, = torch.autograd.grad((TMoE._gather_rows(a, disp, slot) * g).sum(),
                              a)
    pad = torch.cat([b, b.new_zeros((1, b.shape[1]))])
    gb, = torch.autograd.grad((pad[disp] * g).sum(), b)
    torch.testing.assert_close(ga, gb, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ the model
def _model_setup(arch, seq, batch=1):
    cfg, tcfg = _cfgs(arch)
    jparams = jax.jit(lambda: jax_init_train_state(cfg, 0).tree())()[
        "params"]
    tparams = convert.state_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    jb = jax_make_batch(cfg, JaxShape("t", seq, batch, "train"), seed=3)
    tb = make_batch(tcfg, InputShape("t", seq, batch, "train"), seed=3,
                    device="cpu")
    return cfg, tcfg, jparams, tparams, jb, tb


@pytest.mark.parametrize("arch,seq", [(DBRX, 40), (KIMI, 40), (DBRX, 2048)])
def test_loss_aux_and_grads_match_reference(arch, seq):
    """The forward of reduced dbrx and kimi-k2 (every layer MoE; at S
    2048 attention takes `swa_flash`'s path, its plain version here):
    `loss` (with 0.01 aux), `aux` and every gradient against
    `jax.value_and_grad(forward)`. kimi-k2 only at S 40: its reduced
    capacity factor is 384 (the full config's expert count), so at S
    2048 each package's dispatch buffer would hold 4 x 393,217 rows."""
    cfg, tcfg, jparams, tparams, jb, tb = _model_setup(arch, seq)

    @jax.jit
    def vg(p):
        return jax.value_and_grad(lambda q: JM.forward(cfg, q, jb),
                                  has_aux=True)(p)

    (jloss, jout), jgrads = vg(jparams)
    leaves = [p.requires_grad_(True) for p in leaf_arrays(tparams)]
    tloss, tout = TM.forward(tcfg, tparams, tb)
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tout["aux"].item(), float(jout["aux"]),
                               rtol=1e-5)
    assert float(jout["aux"]) > 0
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    paths = [p for p, _ in tree_flatten_with_path(tparams)]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == paths
    assert "['blocks']['pos0']['ffn']['router']" in paths
    for path, (_, jg), tg in zip(paths, jflat, tgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(jg).max()),
                                   err_msg=path)


def test_remat_keeps_loss_and_aux():
    """`torch.utils.checkpoint` per layer: the same loss, aux and
    gradients (the recompute routes the same tokens again)."""
    _, tcfg = _cfgs(DBRX)
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tb = make_batch(tcfg, InputShape("t", 32, 2, "train"), seed=1,
                    device="cpu")
    got = []
    for remat in (False, True):
        leaves = [p.detach().requires_grad_(True)
                  for p in leaf_arrays(params)]
        loss, out = TM.forward(tcfg, ttb.tree_unflatten(params, leaves), tb,
                               remat=remat)
        got.append((loss, out["aux"], torch.autograd.grad(loss, leaves)))
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])
    for a, b in zip(got[0][2], got[1][2]):
        assert torch.equal(a, b)


def test_logits_and_decode_match_reference_and_the_prefill():
    """Reduced dbrx (capacity factor 16, the full config's expert count:
    C >= T k, drop-free):
    `logits_fn` (last logits, every cache) and `decode_step` step by step
    from an empty cache against the reference's; the port's decode of
    the prompt teacher-forced ends at the prefill's logits."""
    cfg, tcfg, jparams, tparams, _, _ = _model_setup(DBRX, 8)
    assert tcfg.capacity_factor >= tcfg.num_experts
    jb = jax_make_batch(cfg, JaxShape("t", 12, 2, "prefill"), seed=5)
    tb = make_batch(tcfg, InputShape("t", 12, 2, "prefill"), seed=5,
                    device="cpu")
    jl, jc = jax.jit(lambda p, b: JM.logits_fn(cfg, p, b))(jparams, jb)
    tl, tc = TM.logits_fn(tcfg, tparams, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["pos0"][name].numpy(),
                                   np.asarray(jc["pos0"][name]),
                                   err_msg=name, **TOL)
    toks = tb["tokens"].numpy()
    jcache = JM.init_cache(cfg, 2, 16)
    tcache = TM.init_cache(tcfg, 2, 16, "cpu")
    jstep = jax.jit(lambda p, c, t: JM.decode_step(cfg, p, c, t))
    for t in range(toks.shape[1]):
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t:t + 1]))
        tlg, tcache = TM.decode_step(tcfg, tparams, tcache,
                                     torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg),
                                   err_msg=f"step {t}", **TOL)
    np.testing.assert_allclose(tlg.numpy(), tl.numpy(), **TOL)
    np.testing.assert_allclose(
        tcache["entries"]["pos0"]["k"][:, :, :12].numpy(),
        tc["pos0"]["k"].numpy(), **TOL)


def test_touched_mask_matches_reference():
    """The experts the router picked over one forward: the port's device
    mask equals the reference's host mask on the same weights and
    batch; `consume` resets it, and a disabled tracker records nothing.
    With the router zeroed every expert ties, and both packages break
    the tie toward the lower index (`jax.lax.top_k`'s rule): experts 0
    and 1 only."""
    cfg, tcfg, jparams, tparams, jb, tb = _model_setup(DBRX, 16, batch=2)
    r = np.zeros((cfg.num_layers, cfg.d_model, cfg.num_experts), np.float32)
    jparams = dict(jparams, blocks={"pos0": dict(
        jparams["blocks"]["pos0"], ffn=dict(
            jparams["blocks"]["pos0"]["ffn"], router=jnp.asarray(r)))})
    tparams["blocks"]["pos0"]["ffn"]["router"] = torch.from_numpy(r)
    try:
        JMoE.TOUCHED.enable(cfg.num_experts)
        TMoE.TOUCHED.enable(tcfg.num_experts)
        jax.jit(lambda p, b: JM.forward(cfg, p, b))(jparams, jb)
        TM.forward(tcfg, tparams, tb)
        seen = TMoE.TOUCHED.peek()
        want, got = JMoE.TOUCHED.consume(), TMoE.TOUCHED.consume()
        assert not TMoE.TOUCHED.peek().any()
    finally:
        JMoE.TOUCHED.disable()
        TMoE.TOUCHED.disable()
    assert got.tolist() == want.tolist() == seen.tolist() == \
        [True, True, False, False]
    TMoE.TOUCHED.enable(4)
    assert not TMoE.TOUCHED.consume().any()
    TMoE.TOUCHED.disable()
    TM.forward(tcfg, tparams, tb)
    assert TMoE.TOUCHED.consume().tolist() == []


# ------------------------------------------------------------ the state
@functools.lru_cache(maxsize=None)
def _states(layers=None, bf16=True):
    kw = dict(dtype="bfloat16", param_dtype="bfloat16") if bf16 else {}
    if layers:
        kw["num_layers"] = layers
    cfg, tcfg = _cfgs(DBRX, **kw)
    jstate = jax.tree.map(np.asarray, jax.jit(
        lambda: jax_init_train_state(cfg, 0).tree())())
    return cfg, tcfg, jstate, convert.state_from_numpy(jstate, device="cpu")


def test_bf16_train_state_stream_matches_reference():
    """The flat spec (paths, shapes, dtypes, offsets; the router fp32 in
    a bf16 model) and the stream, byte for byte; the port's own init
    gives the same spec."""
    _, tcfg, jstate, tstate = _states()
    jspec, tspec = jtb.make_flat_spec(jstate), ttb.make_flat_spec(tstate)
    assert tspec.to_json() == jspec.to_json()
    jbuf = np.zeros(jspec.total_bytes, np.uint8)
    tbuf = np.zeros(tspec.total_bytes, np.uint8)
    jtb.tree_to_buffer(jstate, jspec, jbuf)
    ttb.tree_to_buffer(tstate, tspec, tbuf)
    assert np.array_equal(jbuf, tbuf)
    own = tsteps.init_train_state(tcfg, 0, device="cpu")
    assert ttb.make_flat_spec(own).to_json() == jspec.to_json()
    ffn = own["params"]["blocks"]["pos0"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["wi_gate"].dtype == torch.bfloat16
    assert tuple(ffn["wi_gate"].shape) == (2, 4, 256, 512)


def _flat(spec_fn, buf_fn, tree):
    spec = spec_fn(tree)
    buf = np.zeros(spec.total_bytes, np.uint8)
    buf_fn(tree, spec, buf)
    return buf


def test_moe_state_restores_in_both_directions(tmp_path):
    """A bf16 MoE train state snapshotted by an SG of 3 in each package:
    the port reads the reference's shared memory with a member lost
    (RAIM5), the `.reft` families are byte-identical, and each package
    restores the other's family."""
    _, _, jstate_np, tstate = _states()
    jstate = jax.tree.map(jnp.asarray, jstate_np)
    kw = dict(bucket_bytes=1 << 20, checkpoint_every_snapshots=10 ** 6,
              device_encode="off")
    jg = JaxGroup(3, jstate, JaxConfig(ckpt_dir=str(tmp_path / "jax"), **kw))
    tg = ReftGroup(3, tstate, ReftConfig(ckpt_dir=str(tmp_path / "torch"),
                                         **kw))
    want = _flat(jtb.make_flat_spec, jtb.tree_to_buffer, jstate)
    try:
        assert jg.snapshot(jstate, 5) and tg.snapshot(tstate, 5)
        tree, step, _ = restore_state(jg.run, 3, jg.total_bytes, tstate,
                                      [0, 2])
        assert step == 5
        assert np.array_equal(
            _flat(ttb.make_flat_spec, ttb.tree_to_buffer, tree), want)
        assert jg.checkpoint() == 5 and tg.checkpoint() == 5
        names = sorted(os.listdir(tmp_path / "jax"))
        assert names == sorted(os.listdir(tmp_path / "torch"))
        for name in names:
            assert (tmp_path / "jax" / name).read_bytes() == \
                (tmp_path / "torch" / name).read_bytes(), name
    finally:
        jg.close()
        tg.close()
    tree, step, _ = restore_from_checkpoint(str(tmp_path / "jax"), 3, tstate)
    assert step == 5
    assert np.array_equal(
        _flat(ttb.make_flat_spec, ttb.tree_to_buffer, tree), want)
    tree, step, _ = jax_restore_ckpt(str(tmp_path / "torch"), 3, jstate)
    assert np.array_equal(
        _flat(jtb.make_flat_spec, jtb.tree_to_buffer, tree), want)


@pytest.mark.parametrize("layers", [None, 4], ids=["reduced", "L==E"])
def test_expert_dirty_ranges_against_reference(layers):
    """The touched-expert provider over a MoE train state's flat spec
    (reduced dbrx, float32). At 2 layers and 4 experts both packages
    rule all 45,653,008 B dirty, whatever is touched (the expert leaves
    are stacked over the layers first). At 4 layers (L == E) the
    reference takes the layer axis for the experts': with expert 0 alone
    touched it marks 2,097,152 of `wi_gate`'s 8,388,608 B dirty (layer
    0, all four experts) and rules expert 0's slices of layers 1-3
    clean (1,572,864 B), which the step changed; the port keeps every
    leaf under `blocks` whole."""
    _, _, jstate, tstate = _states(layers, bf16=False)
    jspec, tspec = jtb.make_flat_spec(jstate), ttb.make_flat_spec(tstate)
    whole = [(0, tspec.total_bytes)]
    for touched in ([False] * 4, [True] * 4, [True, False, False, False]):
        assert tdelta.expert_dirty_ranges(tspec, touched) == whole, touched
        if layers is None:
            assert jdelta.expert_dirty_ranges(jspec, touched) == whole
    if layers is None:
        assert tspec.total_bytes == 45_653_008
        return
    want = jdelta.expert_dirty_ranges(jspec, [True, False, False, False])
    leaf = next(l for l in jspec.leaves
                if l.path == "['params']['blocks']['pos0']['ffn']['wi_gate']")
    assert tuple(leaf.shape) == (4, 4, 256, 512)
    assert leaf.nbytes == 8_388_608

    def dirty(lo, hi):
        return sum(max(0, min(hi, b) - max(lo, a)) for a, b in want)

    assert dirty(leaf.offset, leaf.offset + leaf.nbytes) == 2_097_152
    per_layer, per_expert = leaf.nbytes // 4, leaf.nbytes // 16
    expert0 = [leaf.offset + layer * per_layer for layer in (1, 2, 3)]
    assert sum(per_expert for lo in expert0) == 1_572_864
    assert all(dirty(lo, lo + per_expert) == 0 for lo in expert0)
