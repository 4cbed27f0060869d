"""The port's disk baselines (`repro_torch.api.disk`: `sync_disk`,
`async_disk`, plain and sharded) against the JAX package's, on the same
state bytes (a small numpy tree carried over with `convert.py`):

  * the `ckpt-<step>-r<rank>.bin` files are byte-identical (the pickled
    head with the spec JSON and `extra`, then the raw flat stream), through
    the facade backends and through the legacy `repro_torch.ckpt` names;
  * each package's `load_checkpoint` reads the other's files, and both
    agree on `latest_complete_step` and on what keep-latest GC removes;
  * an `async_disk` save launched at step t and drained after the next
    train step has run holds step t's bytes (the port's train step is out
    of place and the writer holds the leaves it was given).
"""
import os
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import repro.ckpt as jax_ckpt
from repro.api import CheckpointSpec as JaxSpec
from repro.api.disk import latest_complete_step as jax_latest
from repro.api.disk import load_checkpoint as jax_load
from repro.api.registry import create_checkpointer as jax_create
from repro.core.treebytes import leaf_arrays as jax_leaf_arrays
import repro_torch.api.disk as disk
import repro_torch.ckpt as ckpt
from repro_torch import convert
from repro_torch.api import CheckpointSpec
from repro_torch.api.registry import create_checkpointer
from repro_torch.core.treebytes import host_bytes, leaf_arrays, state_crc


def _numpy_state(seed=0):
    rng = np.random.default_rng(seed)
    import ml_dtypes
    return {"params": {"w": rng.standard_normal((45, 31)).astype(np.float32),
                       "e": rng.standard_normal(1003)
                       .astype(ml_dtypes.bfloat16)},
            "opt_state": {"nu": {"w": rng.standard_normal((45, 31))
                                 .astype(np.float32)},
                          "step": np.asarray(3, np.int32)},
            "rng": np.asarray([0, 12345], np.uint32),
            "step": np.asarray(7, np.int32)}


def _states(seed=0):
    tree = _numpy_state(seed)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            convert.state_from_numpy(tree, "cpu"))


def _files(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = fh.read()
    return out


def _flat_torch(tree):
    return np.concatenate([host_bytes(x) for x in leaf_arrays(tree)])


def _flat_jax(tree):
    return np.concatenate([np.ascontiguousarray(np.asarray(x)).reshape(-1)
                           .view(np.uint8) for x in jax_leaf_arrays(tree)])


BACKENDS = [("sync_disk", False), ("async_disk", False), ("async_disk", True)]


@pytest.mark.parametrize("backend,shard", BACKENDS)
def test_backend_files_byte_identical(backend, shard, tmp_path):
    jstate, tstate = _states()
    for name, create, spec_cls, state in (
            ("jax", jax_create, JaxSpec, jstate),
            ("torch", create_checkpointer, CheckpointSpec, tstate)):
        spec = spec_cls(backend=backend, ckpt_dir=str(tmp_path / name),
                        sg_size=3, keep=2, options={"shard": shard})
        ck = create(spec, state)
        try:
            for step in (2, 4, 6):
                ck.snapshot(state, step, extra_meta={"ds": step})
                assert ck.persist() == step
        finally:
            ck.close()
    jfiles, tfiles = _files(tmp_path / "jax"), _files(tmp_path / "torch")
    ranks = 3 if shard else 1
    assert sorted(tfiles) == sorted(f"ckpt-{s}-r{r}.bin" for s in (4, 6)
                                    for r in range(ranks))
    assert tfiles == jfiles


@pytest.mark.parametrize("cls,kw", [
    ("CheckFreqCheckpointer", {}),
    ("TorchSnapshotCheckpointer", {"n_ranks": 4}),
    ("AsyncCheckpointer", {"n_ranks": 2, "shard": True}),
])
def test_legacy_writers_byte_identical(cls, kw, tmp_path):
    jstate, tstate = _states(seed=1)
    jw = getattr(jax_ckpt, cls)(str(tmp_path / "jax"), jstate, **kw)
    tw = getattr(ckpt, cls)(str(tmp_path / "torch"), tstate, **kw)
    jw.save_sync(jstate, 5, {"k": [1, 2]})
    times = tw.save_sync(tstate, 5, {"k": [1, 2]})
    assert isinstance(times, ckpt.PhaseTimes) and times.total > 0
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")


@pytest.mark.parametrize("shard", [False, True])
def test_restores_in_both_directions(shard, tmp_path):
    jstate, tstate = _states(seed=2)
    want = _flat_torch(tstate)
    kw = {"n_ranks": 3, "shard": True} if shard else {}
    jax_ckpt.DiskWriter(str(tmp_path / "jax"), jstate, **kw).save_sync(
        jstate, 9, {"ds": 1})
    disk.DiskWriter(str(tmp_path / "torch"), tstate, **kw).save_sync(
        tstate, 9, {"ds": 1})
    # a torn family (rank 0 of 3 only) at a newer step is not complete
    if shard:
        for name in ("jax", "torch"):
            with open(tmp_path / name / "ckpt-9-r0.bin", "rb") as f:
                torn = f.read()
            with open(tmp_path / name / "ckpt-11-r0.bin", "wb") as f:
                f.write(torn)
    for d in ("jax", "torch"):
        assert disk.latest_complete_step(str(tmp_path / d)) == 9 \
            == jax_latest(str(tmp_path / d))
    # the port reads the reference's files, the reference the port's
    got, extra = disk.load_checkpoint(str(tmp_path / "jax"), 9, tstate,
                                      with_meta=True)
    assert extra == {"ds": 1} and np.array_equal(_flat_torch(got), want)
    assert all(t.dtype == s.dtype and t.shape == s.shape for t, s in
               zip(leaf_arrays(got), leaf_arrays(tstate)))
    jgot, jextra = jax_load(str(tmp_path / "torch"), 9, jstate,
                            with_meta=True)
    assert jextra == {"ds": 1} and np.array_equal(_flat_jax(jgot), want)


def test_backend_restore_reports_disk_tier(tmp_path):
    _, tstate = _states(seed=3)
    spec = CheckpointSpec(backend="async_disk", ckpt_dir=str(tmp_path))
    with create_checkpointer(spec, tstate) as ck:
        assert ck.snapshot(tstate, 3, extra_meta={"ds": 3})
        res = ck.restore()
        assert res.tier == "disk" and res.step == 3
        assert res.extra_meta == {"ds": 3}
        assert state_crc(res.state) == state_crc(tstate)
        assert res.load.bytes_read == ck.writer.spec.total_bytes
        assert ck.health()["healthy"]


def test_async_save_holds_the_launched_step(monkeypatch, tmp_path):
    """Launch an async save at step t, run step t+1 before the writer has
    read a byte, then let it go: the file holds step t's state."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.train.steps import init_train_state, make_train_step

    cfg = get_config("opt-125m").reduced()
    state = init_train_state(cfg, 0, device="cpu")
    ds = SyntheticDataset(cfg, InputShape("t", 32, 2, "train"), seed=0,
                          device="cpu")
    step_fn = make_train_step(cfg)
    state, _ = step_fn(state, next(ds))

    gate = threading.Event()

    class HeldReader(disk._LeafReader):
        def __init__(self, *a, **kw):
            assert gate.wait(60)
            super().__init__(*a, **kw)

    monkeypatch.setattr(disk, "_LeafReader", HeldReader)
    spec = CheckpointSpec(backend="async_disk", ckpt_dir=str(tmp_path))
    with create_checkpointer(spec, state) as ck:
        launched = state_crc(state)
        assert ck.snapshot(state, 1)
        assert ck.health()["members"]["inflight"]
        state, _ = step_fn(state, next(ds))         # the next step runs
        assert state_crc(state) != launched
        gate.set()
        ck.wait()
        got = disk.load_checkpoint(str(tmp_path), 1, state)
        assert state_crc(got) == launched
