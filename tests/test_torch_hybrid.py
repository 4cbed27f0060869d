"""The port's hybrid family (Jamba: attention, SSM and MoE layers in a
period of `_stack_period` layers, params stacked `pos0..posK-1` over the
periods) against the JAX package's, on the CPU, on JAX-initialised
weights carried across by `repro_torch.convert` and the same inputs
(numpy, seeded), float32 unless stated. Reduced Jamba: period 2 (an SSM
layer with an MLP, then an attention layer with the MoE), 4 experts
top-2 at a capacity factor of 16 (drop-free).

Tolerances (`tests/test_torch_moe.py`'s):
  * loss and aux rtol 1e-5; every gradient rtol 1e-4 and atol 1e-5 of
    its leaf's largest magnitude (the experts' float32 noise reaches the
    embedding's gradient);
  * `logits_fn`, its caches and `decode_step` atol 2e-4, rtol 2e-3
    (`tests/test_torch_decode.py`'s), against the reference and against
    the port's own prefill;
  * init trees, byte streams, restores and dirty ranges: exact.
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
from repro.launch import dryrun as JDR
from repro.models import model as JM
from repro.train.steps import init_train_state as jax_init_train_state
from repro_torch import convert
from repro_torch.configs import list_configs
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import InputShape
from repro_torch.core import delta as tdelta
from repro_torch.core import treebytes as ttb
from repro_torch.core.coordinator import ReftGroup
from repro_torch.core.recovery import restore_from_checkpoint, restore_state
from repro_torch.core.snapshot import ReftConfig
from repro_torch.core.treebytes import leaf_arrays, tree_flatten_with_path
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import dryrun as TDR
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.train import steps as tsteps

JAMBA = "jamba-v0.1-52b"
TOL = dict(atol=2e-4, rtol=2e-3)


def _cfgs(reduced=True, **kw):
    j, t = get_config(JAMBA), tget(JAMBA)
    if reduced:
        j, t = j.reduced(), t.reduced()
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


@functools.lru_cache(maxsize=None)
def _params(layers, chunk=None):
    cfg, tcfg = _cfgs(num_layers=layers,
                      **({"ssd_chunk": chunk} if chunk else {}))
    jparams = jax.jit(lambda: jax_init_train_state(cfg, 0).tree())()[
        "params"]
    tparams = convert.state_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    return cfg, tcfg, jparams, tparams


def _value_and_grads(layers, seq, chunk=None):
    """(jax loss, aux, grads), (port loss, aux, grads, paths) of one
    forward on the same weights and batch."""
    cfg, tcfg, jparams, tparams = _params(layers, chunk)
    jb = jax_make_batch(cfg, JaxShape("t", seq, 1, "train"), seed=3)
    tb = make_batch(tcfg, InputShape("t", seq, 1, "train"), seed=3,
                    device="cpu")
    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(
        lambda q: JM.forward(cfg, q, jb), has_aux=True))(jparams)
    tparams = ttb.tree_unflatten(tparams, [
        p.detach().requires_grad_(True) for p in leaf_arrays(tparams)])
    tloss, tout = TM.forward(tcfg, tparams, tb)
    tgrads = torch.autograd.grad(tloss, leaf_arrays(tparams))
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    paths = [p for p, _ in tree_flatten_with_path(tparams)]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == paths
    return ((float(jloss), float(jout["aux"]),
             [np.asarray(g) for _, g in jflat]),
            (tloss.item(), tout["aux"].item(), tgrads, paths))


def _shapes(tree):
    """[(keystr path, shape, dtype name)] of a JAX tree."""
    return [(jax.tree_util.keystr(p), tuple(l.shape), np.dtype(l.dtype).name)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _tshapes(tree):
    """The same of a torch tree, in the port's (JAX's) flatten order."""
    return [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in tree_flatten_with_path(tree)]


# ---------------------------------------------------------- the layout
@pytest.mark.parametrize("reduced,layers,period", [
    (True, 2, 2), (True, 4, 2), (False, 8, 8), (False, 32, 8)],
    ids=["reduced-2", "reduced-4", "full-8", "full-32"])
def test_init_tree_matches_reference(reduced, layers, period):
    """`init_params`' paths, shapes and dtypes (the port's on the meta
    device at full width) equal `jax.eval_shape` of the reference's, in
    JAX's flatten order; `_stack_period` equals the reference's, and
    every position's kind and FFN follow the config's pattern."""
    cfg, tcfg = _cfgs(reduced, num_layers=layers)
    assert TM._stack_period(tcfg) == JM._stack_period(cfg) == \
        (period, layers // period)
    want = _shapes(jax.eval_shape(
        lambda: JM.init_params(cfg, jax.random.PRNGKey(0))))
    got = _tshapes(TM.init_params(tcfg, torch.Generator().manual_seed(0),
                                  "cpu" if reduced else "meta"))
    assert got == want
    blocks = {p for p, *_ in got if p.startswith("['blocks']")}
    for i in range(period):
        pos = f"['blocks']['pos{i}']"
        attn = tcfg.layer_kind(i) == "attn"
        assert (f"{pos}['mix']['wq']" in blocks) == attn
        assert (f"{pos}['mix']['A_log']" in blocks) == (not attn)
        assert (f"{pos}['ffn']['router']" in blocks) == tcfg.layer_is_moe(i)


@pytest.mark.parametrize("layers,seq", [(2, 64), (2, 320), (4, 64),
                                        (4, 320)])
def test_loss_aux_and_grads_match_reference(layers, seq):
    """`loss` (with 0.01 aux), `aux` and every gradient against
    `jax.value_and_grad(forward)`. The SSD chunk is cut to 16 in both
    packages (4 and 20 chunks, the state carried across each), as
    `tests/test_torch_ssm_model.py` cuts it: at the reduced chunk of 256
    the reference's gradient is NaN at these lengths
    (`test_grads_stay_finite_where_the_reference_is_nan`)."""
    (jloss, jaux, jgrads), (tloss, taux, tgrads, paths) = \
        _value_and_grads(layers, seq, 16)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    np.testing.assert_allclose(taux, jaux, rtol=1e-5)
    assert jaux > 0
    for path, jg, tg in zip(paths, jgrads, tgrads):
        assert float(np.abs(jg).max()) > 0, path
        np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(jg).max()),
                                   err_msg=path)


def test_grads_stay_finite_where_the_reference_is_nan():
    """Reduced Jamba at its own SSD chunk (256), S 320 (two chunks): the
    loss and aux agree, the reference's `ssd_chunked` overflows exp in
    its masked triangle and its gradients go NaN (ROADMAP §3), the port's
    stay finite (it masks before the exp)."""
    (jloss, jaux, jgrads), (tloss, taux, tgrads, paths) = \
        _value_and_grads(2, 320)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    np.testing.assert_allclose(taux, jaux, rtol=1e-5)
    assert any(np.isnan(g).any() for g in jgrads)
    for path, tg in zip(paths, tgrads):
        assert torch.isfinite(tg).all() and tg.abs().max() > 0, path


@pytest.mark.parametrize("layers", [2, 4])
def test_logits_caches_and_decode_match_reference(layers):
    """`logits_fn`'s last logits and every `pos*` cache (attention k/v,
    SSM conv/h), then 24 `decode_step`s from an empty cache, step by step
    against the reference's; the port's decode of the prompt ends at its
    own prefill's logits and caches."""
    cfg, tcfg, jparams, tparams = _params(layers)
    T, smax = 24, 32
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, T)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: JM.logits_fn(
        cfg, p, {"tokens": t, "labels": t}))(jparams, jnp.asarray(toks))
    tl, tc = TM.logits_fn(tcfg, tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert set(tc) == set(jc) == {"pos0", "pos1"}
    assert set(tc["pos0"]) == {"conv", "h"} and set(tc["pos1"]) == {"k",
                                                                    "v"}
    for pos in tc:
        for name, t in tc[pos].items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jc[pos][name]),
                                       err_msg=f"{pos} {name}", **TOL)
    jcache = JM.init_cache(cfg, 2, smax)
    tcache = TM.init_cache(tcfg, 2, smax, "cpu")
    assert _tshapes(tcache) == _shapes(jcache)
    jstep = jax.jit(lambda p, c, t: JM.decode_step(cfg, p, c, t))
    for t in range(T):
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t:t + 1]))
        tlg, tcache = TM.decode_step(tcfg, tparams, tcache,
                                     torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg),
                                   err_msg=f"step {t}", **TOL)
    assert int(tcache["index"]) == T
    np.testing.assert_allclose(tlg.numpy(), tl.numpy(), **TOL)
    ent = tcache["entries"]
    for name in ("k", "v"):
        np.testing.assert_allclose(ent["pos1"][name][:, :, :T].numpy(),
                                   tc["pos1"][name].numpy(), **TOL)
        assert not ent["pos1"][name][:, :, T:].any()
    for name in ("conv", "h"):
        np.testing.assert_allclose(ent["pos0"][name].numpy(),
                                   tc["pos0"][name].numpy(), **TOL)


# ----------------------------------------------------------- the state
@functools.lru_cache(maxsize=None)
def _states(layers=2, bf16=True):
    kw = dict(dtype="bfloat16", param_dtype="bfloat16") if bf16 else {}
    cfg, tcfg = _cfgs(num_layers=layers, **kw)
    jstate = jax.tree.map(np.asarray, jax.jit(
        lambda: jax_init_train_state(cfg, 0).tree())())
    return cfg, tcfg, jstate, convert.state_from_numpy(jstate, device="cpu")


def _flat(spec_fn, buf_fn, tree):
    spec = spec_fn(tree)
    buf = np.zeros(spec.total_bytes, np.uint8)
    buf_fn(tree, spec, buf)
    return buf


@pytest.mark.parametrize("period", [2, 8])
def test_bf16_train_state_stream_matches_reference(period):
    """The flat spec (paths, shapes, dtypes, offsets; the router fp32 in
    a bf16 model) and the stream, byte for byte, at the reduced period 2
    (4 layers) and at Jamba's period 8 (reduced widths, 8 layers: the
    keys `pos0..pos7` in JAX's sorted order); the port's own init gives
    the same spec."""
    kw = {} if period == 2 else dict(attn_period=8, attn_index=4)
    cfg, tcfg = _cfgs(num_layers=4 if period == 2 else 8,
                      dtype="bfloat16", param_dtype="bfloat16", **kw)
    if period == 2:
        jstate, tstate = _states(4)[2:]
    else:
        jstate = jax.tree.map(np.asarray, jax.jit(
            lambda: jax_init_train_state(cfg, 0).tree())())
        tstate = convert.state_from_numpy(jstate, device="cpu")
    assert TM._stack_period(tcfg)[0] == period
    jspec, tspec = jtb.make_flat_spec(jstate), ttb.make_flat_spec(tstate)
    assert tspec.to_json() == jspec.to_json()
    assert np.array_equal(_flat(jtb.make_flat_spec, jtb.tree_to_buffer,
                                jstate),
                          _flat(ttb.make_flat_spec, ttb.tree_to_buffer,
                                tstate))
    own = tsteps.init_train_state(tcfg, 0, device="cpu")
    assert ttb.make_flat_spec(own).to_json() == jspec.to_json()
    blocks = own["params"]["blocks"]
    assert sorted(blocks) == [f"pos{i}" for i in range(period)]
    moe = blocks[f"pos{tcfg.moe_offset}"]["ffn"]
    assert moe["router"].dtype == torch.float32
    assert moe["wi_gate"].dtype == torch.bfloat16


def test_hybrid_state_restores_in_both_directions(tmp_path):
    """A bf16 reduced-Jamba train state (4 layers, 2 periods) snapshotted
    by an SG of 3 in each package: the port reads the reference's shared
    memory with a member lost (RAIM5), the `.reft` families are
    byte-identical, and each package restores the other's family."""
    _, _, jstate_np, tstate = _states(4)
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


def test_expert_dirty_ranges_at_n_periods_equal_to_experts():
    """The touched-expert provider over reduced Jamba at 8 layers
    (float32): 4 periods, 4 experts, the MoE at position 1 only. The
    reference takes the period axis of `pos1`'s expert leaves for the
    experts': with expert 0 alone touched it marks period 0's slice of
    `wi_gate` dirty (every expert) and rules expert 0's slices of
    periods 1-3 clean, bytes the step changed; the port keeps every
    leaf under `blocks` whole, and both rule the whole state dirty when
    every expert or none is touched."""
    _, _, jstate, tstate = _states(8, bf16=False)
    jspec, tspec = jtb.make_flat_spec(jstate), ttb.make_flat_spec(tstate)
    whole = [(0, tspec.total_bytes)]
    for touched in ([False] * 4, [True] * 4, [True, False, False, False]):
        assert tdelta.expert_dirty_ranges(tspec, touched) == whole, touched
    assert jdelta.expert_dirty_ranges(jspec, [True] * 4) == whole
    want = jdelta.expert_dirty_ranges(jspec, [True, False, False, False])
    leaf = next(l for l in jspec.leaves
                if l.path == "['params']['blocks']['pos1']['ffn']['wi_gate']")
    assert tuple(leaf.shape) == (4, 4, 256, 512)
    assert not any("['pos0']['ffn']['router']" in l.path
                   for l in jspec.leaves)

    def dirty(lo, hi):
        return sum(max(0, min(hi, b) - max(lo, a)) for a, b in want)

    per_period, per_expert = leaf.nbytes // 4, leaf.nbytes // 16
    assert dirty(leaf.offset, leaf.offset + leaf.nbytes) == per_period
    expert0 = [leaf.offset + p * per_period for p in (1, 2, 3)]
    assert all(dirty(lo, lo + per_expert) == 0 for lo in expert0)


# --------------------------------------------------- the CLI and dry-run
@pytest.mark.parametrize("reduced,layers,period", [
    (True, "1", 2), (False, "12", 8)])
def test_layers_must_be_a_multiple_of_the_period(reduced, layers, period,
                                                 capsys):
    argv = ["--device", "cpu", "--arch", JAMBA, "--layers", layers,
            *(["--reduced"] if reduced else [])]
    with pytest.raises(SystemExit) as e:
        ttrain.run(argv)
    assert e.value.code == 2
    assert f"period of {period} layers" in capsys.readouterr().err


def test_extrapolation_period_matches_reference():
    """The dry-run's roofline tiles each registered config by the same
    layer count as the reference's: the hybrid period (8 for Jamba) and
    the local:global interleave; `check_supported` takes every one."""
    got = {n: TDR.extrapolation_period(tget(n)) for n in list_configs()}
    want = {n: JDR.extrapolation_period(get_config(n)) for n in got}
    assert got == want
    assert got[JAMBA] == 8
    for n in got:
        TM.check_supported(tget(n))
