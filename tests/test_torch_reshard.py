"""Reshard-on-restore in the port: `core.loader.need_for_sharding` against
the reference's on the reference's cases and on a reduced opt-125m state
under `state_specs` at every coordinate of (2, 2) and (1, 4) meshes, and
one restore through `RestoreTarget(shardings, mesh, coord)` that reads
the reference's snapshot files."""
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from repro.api import CheckpointSpec as JaxSpec
from repro.api.registry import create_checkpointer as jax_create
from repro.configs import get_config as jax_config
from repro.core import loader as jax_loader
from repro.core.treebytes import make_flat_spec as jax_flat_spec
from repro.dist import shardings as jax_sh
from repro.train.steps import init_train_state as jax_init_state
from repro_torch import convert
from repro_torch.api import CheckpointSpec, RestoreTarget
from repro_torch.api.registry import create_checkpointer
from repro_torch.configs import get_config
from repro_torch.core import loader
from repro_torch.core.treebytes import (host_bytes, leaf_arrays,
                                        make_flat_spec, tree_map)
from repro_torch.dist import shardings as SH
from repro_torch.dist.api import P
from repro_torch.train.steps import init_train_state


def fake_mesh(**axes):
    return SimpleNamespace(axis_names=tuple(axes),
                           axis_sizes=tuple(axes.values()))


def _both(state_np, port_specs, ref_specs, mesh, coord):
    got = loader.need_for_sharding(
        make_flat_spec(convert.state_from_numpy(state_np, "cpu")),
        port_specs, mesh, coord)
    want = jax_loader.need_for_sharding(jax_flat_spec(state_np), ref_specs,
                                        mesh, coord)
    assert got == want
    return got


# the reference's cases (tests/test_loader.py, "dist target -> ranges")
def test_need_for_sharding_slices_leading_dim():
    state = {"w": np.zeros((8, 4), np.float32),
             "b": np.zeros((6,), np.float32)}
    spec = make_flat_spec(convert.state_from_numpy(state, "cpu"))
    mesh = fake_mesh(data=2, model=2)
    w_nbytes = 8 * 4 * 4
    need0 = _both(state, {"w": P("data", None), "b": P()},
                  {"w": JP("data", None), "b": JP()}, mesh, {"data": 0})
    need1 = _both(state, {"w": P("data", None), "b": P()},
                  {"w": JP("data", None), "b": JP()}, mesh, {"data": 1})
    w_off = next(l.offset for l in spec.leaves if "w" in l.path)
    b_off = next(l.offset for l in spec.leaves if "b" in l.path)
    assert (w_off, w_off + w_nbytes // 2) in need0
    assert (w_off + w_nbytes // 2, w_off + w_nbytes) in need1
    for need in (need0, need1):           # unsharded leaf: the whole leaf
        assert (b_off, b_off + 24) in need
    need = _both(state, {"w": P(None, "model"), "b": P("model",)},
                 {"w": JP(None, "model"), "b": JP("model",)}, mesh,
                 {"model": 1})
    assert (b_off + 12, b_off + 24) in need


def test_need_for_sharding_strided_and_fallback_cases():
    """A trailing-dim shard (one range a leading row), a tuple entry over
    two axes, a non-dividing dim (whole leaf) and a leaf past the range
    cap (whole leaf), each equal to the reference's."""
    state = {"a": np.zeros((6, 8), np.float32),
             "c": np.zeros((16, 3), np.float32),
             "d": np.zeros((5, 4), np.float32),
             "e": np.zeros((loader.MAX_SLAB_RANGES + 1, 2), np.float32)}
    mesh = fake_mesh(data=2, model=4)
    port = {"a": P(None, "model"), "c": P(("data", "model"), None),
            "d": P("model", None), "e": P(None, "data")}
    ref = {"a": JP(None, "model"), "c": JP(("data", "model"), None),
           "d": JP("model", None), "e": JP(None, "data")}
    for d in range(2):
        for m in range(4):
            _both(state, port, ref, mesh, {"data": d, "model": m})


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_opt125m_state_ranges_equal_the_reference(shape):
    """Reduced opt-125m's train state under `state_specs`, every
    coordinate of the mesh: the same ranges as the reference's."""
    mesh = fake_mesh(data=shape[0], model=shape[1])
    cfg = get_config("opt-125m").reduced()
    port_state = init_train_state(cfg, 0, device="cpu")
    port_spec = make_flat_spec(port_state)
    ref_state = jax_init_state(jax_config("opt-125m").reduced(), 0).tree()
    ref_spec = jax_flat_spec(ref_state)
    def rows(fs):
        return [(l.path, tuple(l.shape), l.dtype, l.offset, l.nbytes)
                for l in fs.leaves]
    assert rows(port_spec) == rows(ref_spec)
    port_sh = SH.state_specs(cfg, port_state)
    ref_sh = jax_sh.state_specs(jax_config("opt-125m").reduced(), ref_state)
    sharded = 0
    for d in range(shape[0]):
        for m in range(shape[1]):
            coord = {"data": d, "model": m}
            got = loader.need_for_sharding(port_spec, port_sh, mesh, coord)
            want = jax_loader.need_for_sharding(ref_spec, ref_sh, mesh,
                                                coord)
            assert got == want, coord
            total = sum(b - a for a, b in loader.normalize_ranges(
                got, port_spec.total_bytes))
            sharded += total < port_spec.total_bytes
    assert sharded == shape[0] * shape[1]      # every rank reads a slice


def test_restore_through_a_sharding_target_reads_the_reference_files(
        tmp_path):
    """The reference persists reduced opt-125m's state (an SG of 2, its
    .reft family); a port checkpointer over that directory, holding a
    zero template, restores rank (data 1, model 0) of a (2, 2) mesh
    through `RestoreTarget(shardings, mesh, coord)`: every byte of the
    rank's ranges is the saved byte, every other byte the template's; the
    plan covers exactly those ranges, and the loader reads what the
    reference's reads for the same target (the plan's ranges and the CRC
    probe of each member's own region)."""
    from repro.api import RestoreTarget as JaxTarget
    cfg = get_config("opt-125m").reduced()
    jcfg = jax_config("opt-125m").reduced()
    state = init_train_state(cfg, 0, device="cpu")
    state_np = tree_map(lambda t: t.numpy(), state)
    saved = np.concatenate([host_bytes(x) for x in leaf_arrays(state)])
    jstate = jax.tree_util.tree_map(jnp.asarray, state_np)
    jspec = JaxSpec(backend="objstore", ckpt_dir=str(tmp_path), sg_size=2,
                    options={"scrub_every_s": 0.0})
    with jax_create(jspec, jstate) as ck:
        assert ck.snapshot(jstate, 5, wait=True)
        assert ck.persist(wait=True) == 5
    mesh = fake_mesh(data=2, model=2)
    coord = {"data": 1, "model": 0}
    shardings = SH.state_specs(cfg, state)
    fs = make_flat_spec(state)
    need = loader.normalize_ranges(
        loader.need_for_sharding(fs, shardings, mesh, coord), fs.total_bytes)
    template = tree_map(lambda t: t.new_zeros(t.shape), state)
    spec = CheckpointSpec(backend="objstore", ckpt_dir=str(tmp_path),
                          sg_size=2, options={"scrub_every_s": 0.0})
    with create_checkpointer(spec, template) as ck:
        res = ck.restore(target=RestoreTarget(shardings=shardings, mesh=mesh,
                                              coord=coord))
    jtemplate = jax.tree_util.tree_map(jnp.zeros_like, jstate)
    with jax_create(jspec, jtemplate) as ck:
        jres = ck.restore(target=JaxTarget(
            shardings=jax_sh.state_specs(jcfg, jstate), mesh=mesh,
            coord=coord))
    assert (res.tier, res.step) == (jres.tier, jres.step) == \
        ("checkpoint", 5)
    got = np.concatenate([host_bytes(x) for x in leaf_arrays(res.state)])
    want = np.zeros_like(saved)
    for a, b in need:
        want[a:b] = saved[a:b]
    assert np.array_equal(got, want)
    n_need = sum(b - a for a, b in need)
    assert 0 < n_need < fs.total_bytes
    assert res.load.bytes_needed == jres.load.bytes_needed == n_need
    assert res.load.bytes_read == jres.load.bytes_read
    # the plan's ranges, and the probe of both members' own regions
    assert res.load.bytes_read == n_need + fs.total_bytes


def test_reshard_restores_read_the_plan_and_the_probe_only():
    """`chip_smoke.py`'s phase 9(d) at reduced width on the CPU: opt-125m's
    state snapshotted in memory by an SG of 4 (per-stripe digests),
    restored at each coordinate of a (2, 2) mesh: byte-exact, and bytes
    read within the plan plus the CRC probe's blocks, parity reroutes and
    hedged reads (the phase raises otherwise); then a full restore,
    byte-exact, reading each member's own region once plus the same
    scheduler allowance."""
    import chip_smoke
    import torch
    from repro_torch.core import raim5
    rows, full = chip_smoke._reshard_run(
        torch, device="cpu", cfg=get_config("opt-125m").reduced())
    assert [r["coord"] for r in rows] == [
        {"data": d, "model": m} for d in range(2) for m in range(2)]
    assert {r["tier"] for r in rows} == {full["tier"]} == {"in-memory"}
    n = chip_smoke.SG
    assert full["own_regions"] == \
        n * (n - 1) * raim5.block_size(full["state_bytes"], n)
    assert full["own_regions"] <= full["bytes_read"] <= full["bound"]
    for r in rows:
        assert 0 < r["bytes_needed"] < r["state_bytes"]
        assert r["bytes_needed"] + r["probe_allowance"] >= r["bytes_read"]
