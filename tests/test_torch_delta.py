"""Dirty-delta snapshotting in the port (`repro_torch.core.delta` driven
through `SnapshotEngine` / `ReftGroup` with `delta=True`) against the JAX
package, on the same sequence of states; every comparison is exact:

  * both packages take the same delta and keyframe decisions, skip the
    same buckets and publish the same SMP bytes (own and parity regions,
    metadata), with the device encode off and on (on the CPU, "on" runs
    the kernel's plain version in the port — a kind-2 bucket with its CRC
    on the delta path — and the interpret-mode Pallas kernel in the
    reference); their persist rounds write the same `.reft` / `.reftd`
    kinds;
  * each package restores the other's keyframe + delta chain at every
    step, byte-identical to the state that step saved;
  * a provider reporting most bytes dirty forces a keyframe, a sparse one
    gives a delta flight whose shard is byte-identical to the live state;
  * a 3-member delta family resumes into a 5-member SG in both packages;
  * the CLI: `launch.train --device cpu --reduced --delta` restores
    byte-exact, `--delta` under a disk backend is refused, and
    `--no-reft` runs as `--backend null`.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.coordinator import ReftGroup as JaxGroup
from repro.core.recovery import latest_checkpoint_step as jax_latest
from repro.core.recovery import restorable_steps as jax_restorable
from repro.core.recovery import restore_from_checkpoint as jax_restore_ckpt
from repro.core.recovery import restore_state as jax_restore_state
from repro.core.smp import ReadOnlyNode as JaxView
from repro.core.snapshot import ReftConfig as JaxConfig
from repro.core.snapshot import SnapshotEngine as JaxEngine
from repro_torch import convert
from repro_torch.core.coordinator import ReftGroup
from repro_torch.core.recovery import (latest_checkpoint_step,
                                       restorable_steps,
                                       restore_from_checkpoint,
                                       restore_state)
from repro_torch.core.smp import ReadOnlyNode
from repro_torch.core.snapshot import ReftConfig, SnapshotEngine
from repro_torch.supervise import trees_equal

DELTA_STATS = ("delta_flights", "keyframe_flights", "skipped_buckets",
               "delta_base_misses", "snapshots")


def np_state(n_leaves=4, shape=(32, 64), seed=0):
    rng = np.random.RandomState(seed)
    return {f"w{i}": rng.rand(*shape).astype(np.float32)
            for i in range(n_leaves)}


def _as(pkg, tree):
    if pkg == "jax":
        return jax.tree.map(jnp.asarray, tree)
    return convert.state_from_numpy(tree, device="cpu")


def _probe(view_cls, run, n, total, step):
    out = []
    for node in range(n):
        v = view_cls(run, node, n, total)
        try:
            out.append((v.read_own(step).tobytes(),
                        v.read_parity(step).tobytes(),
                        pickle.loads(v.meta(step))))
        finally:
            v.close()
    return out


def _chain(pkg, d, n, device_encode, steps, state_fn, shape_kw):
    """Snapshot `steps` states (one leaf changes a step) with a persist
    round after each; returns (states, persist kinds, engine stats per
    step, SMP probes per step)."""
    jax_side = pkg == "jax"
    cfg = (JaxConfig if jax_side else ReftConfig)(
        ckpt_dir=d, bucket_bytes=2048, delta=True, delta_keyframe=8,
        delta_dirty_threshold=0.9, device_encode=device_encode,
        checkpoint_every_snapshots=10 ** 9)
    group = (JaxGroup if jax_side else ReftGroup)(
        n, _as(pkg, np_state(**shape_kw)), cfg)
    view = JaxView if jax_side else ReadOnlyNode
    latest = jax_latest if jax_side else latest_checkpoint_step
    states, kinds, stats, probes = {}, [], [], []
    try:
        for step in range(steps):
            st = state_fn(step)
            states[step] = st
            assert group.snapshot(_as(pkg, st), step, wait=True)
            assert group.checkpoint_async(
                delta_base=latest(d, n)) is not None
            r = group.drain_persists()[-1]
            assert r["ok"], r
            kinds.append(r["kind"])
            stats.append([{k: e.stats[k] for k in DELTA_STATS}
                          for e in group.engines])
            probes.append(_probe(view, group.run, n, group.total_bytes,
                                 step))
    finally:
        group.close()
    return states, kinds, stats, probes


def _one_leaf_changes(step, base=np_state()):
    st = dict(base)
    st["w1"] = base["w1"] + np.float32(step + 1)
    return st


@pytest.mark.parametrize("device_encode", ["off", "on"])
def test_delta_chain_matches_reference_both_ways(device_encode, tmp_path):
    runs = {pkg: _chain(pkg, str(tmp_path / pkg), 2, device_encode, 4,
                        _one_leaf_changes, {})
            for pkg in ("jax", "torch")}
    (states, kinds, stats, probes) = runs["torch"]
    assert kinds == runs["jax"][1] == ["full", "delta", "delta", "delta"]
    assert stats == runs["jax"][2]
    assert stats[-1][0]["delta_flights"] >= 1
    assert stats[-1][0]["skipped_buckets"] > 0      # clean buckets skip
    for step, (g, w) in enumerate(zip(probes, runs["jax"][3])):
        for node in range(2):
            assert g[node][0] == w[node][0], f"{step}/{node}: own differs"
            assert g[node][1] == w[node][1], f"{step}/{node}: parity"
            assert g[node][2] == w[node][2], f"{step}/{node}: meta"
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert restorable_steps(jd, 2) == jax_restorable(td, 2) == [0, 1, 2, 3]
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    for name in sorted(os.listdir(jd)):
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "torch" / name).read_bytes(), name
    for step, want in states.items():
        got, at, _ = restore_from_checkpoint(jd, 2, _as("torch", np_state()),
                                             step=step)
        assert at == step and trees_equal(got, want)
        got, at, _ = jax_restore_ckpt(td, 2, _as("jax", np_state()),
                                      step=step)
        assert at == step and trees_equal(
            jax.tree.map(np.asarray, got), want)


def _threshold(pkg):
    """The reference's keyframe-at-the-threshold sequence; returns the
    stats after each flight, the shm bytes of the delta step and the
    restored tree."""
    jax_side = pkg == "jax"
    a, b = np.zeros(4096, np.float32), np.ones(4096, np.float32)
    state = {"a": a, "b": b}
    a2 = a.copy()
    a2[:8] = 7.0
    state2 = {"a": a2, "b": b}
    cfg = (JaxConfig if jax_side else ReftConfig)(
        bucket_bytes=2048, delta=True, delta_keyframe=100,
        delta_dirty_threshold=0.05, checkpoint_every_snapshots=10 ** 9)
    eng = (JaxEngine if jax_side else SnapshotEngine)(0, 1, _as(pkg, state),
                                                      cfg)
    dirty = [None]
    eng.set_dirty_provider(lambda: dirty[0])
    seen = []
    try:
        total = eng.spec.total_bytes
        assert eng.snapshot_sync(_as(pkg, state), 1) == 1   # keyframe
        seen.append({k: eng.stats[k] for k in DELTA_STATS})
        dirty[0] = [(0, total)]                     # dense -> keyframe
        assert eng.snapshot_sync(_as(pkg, state), 2) == 2
        seen.append({k: eng.stats[k] for k in DELTA_STATS})
        dirty[0] = [(0, 64)]                        # sparse real change
        assert eng.snapshot_sync(_as(pkg, state2), 3) == 3
        seen.append({k: eng.stats[k] for k in DELTA_STATS})
        view = JaxView if jax_side else ReadOnlyNode
        probe = _probe(view, eng.run, 1, total, 3)
        restore = jax_restore_state if jax_side else restore_state
        rec, at, _ = restore(eng.run, 1, total, _as(pkg, state), [0])
    finally:
        eng.close()
    return seen, probe, at, jax.tree.map(np.asarray, rec) if jax_side \
        else rec, state2


def test_keyframe_forced_at_dirty_threshold_matches_reference():
    want, got = _threshold("jax"), _threshold("torch")
    assert got[0] == want[0]
    assert [s["keyframe_flights"] for s in got[0]] == [1, 2, 2]
    assert [s["delta_flights"] for s in got[0]] == [0, 0, 1]
    assert got[0][-1]["skipped_buckets"] > 0
    assert got[1] == want[1]
    assert got[2] == want[2] == 3
    assert trees_equal(got[3], got[4]) and trees_equal(want[3], got[4])


def test_delta_family_elastic_resume_both_ways(tmp_path):
    """A 3-member delta family resumes into a 5-member SG, the port's
    family through both loaders and the reference's through the port's."""
    def change(step, base=np_state(8, (64, 64))):
        st = dict(base)
        st["w2"] = base["w2"] + np.float32(step + 1)
        return st

    runs = {pkg: _chain(pkg, str(tmp_path / pkg), 3, "off", 3, change,
                        {"n_leaves": 8, "shape": (64, 64)})
            for pkg in ("jax", "torch")}
    states = runs["torch"][0]
    assert runs["torch"][1] == runs["jax"][1] == ["full", "delta", "delta"]
    template = np_state(8, (64, 64))
    for d in (str(tmp_path / "jax"), str(tmp_path / "torch")):
        got, at, _ = restore_from_checkpoint(d, 5, _as("torch", template),
                                             step=2)
        assert at == 2 and trees_equal(got, states[2])
    got, at, _ = jax_restore_ckpt(str(tmp_path / "torch"), 5,
                                  _as("jax", template), step=2)
    assert at == 2 and trees_equal(jax.tree.map(np.asarray, got), states[2])


# ---------------------------------------------------------------- CLI
def _train(tmp_path, *extra):
    from repro_torch.launch import train
    torch.set_num_threads(1)
    return train.run(["--device", "cpu", "--arch", "opt-125m", "--reduced",
                      "--steps", "12", "--batch", "2", "--seq", "32",
                      "--snapshot-every", "2", "--ckpt-every", "4",
                      "--ckpt-dir", str(tmp_path), *extra])


def test_train_cli_delta_restores_byte_exact(tmp_path, capsys):
    rep = _train(tmp_path, "--delta", "--inject", "6:software",
                 "--inject", "10:node", "--verify-restores")
    assert [(r["tier"], r["bit_exact"]) for r in rep["recoveries"]] == \
        [("in-memory", True), ("raim5", True)]
    st = rep["stats"]
    assert st["delta_flights"] > 0 and st["keyframe_flights"] > 0
    assert st["delta_base_misses"] == 0
    out = capsys.readouterr().out
    assert "backend=reft device=cpu delta" in out
    assert f"delta_flights={st['delta_flights']} " in out


@pytest.mark.parametrize("backend", ["sync_disk", "async_disk", "null"])
def test_train_cli_delta_refused_outside_the_reft_family(backend, tmp_path,
                                                         capsys):
    with pytest.raises(SystemExit) as e:
        _train(tmp_path, "--delta", "--backend", backend)
    assert e.value.code == 2
    assert "--delta needs the reft backend family" in capsys.readouterr().err


def test_train_cli_no_reft_is_backend_null(tmp_path, capsys):
    rep = _train(tmp_path, "--no-reft", "--steps", "3")
    assert len(rep["losses"]) == 3 and not rep["recoveries"]
    assert rep["stats"]["backend"] == "null"
    out = capsys.readouterr().out
    assert "backend=null" in out and "[null] snapshots=" in out
    with pytest.raises(SystemExit):
        _train(tmp_path, "--no-reft", "--inject", "2:node")
