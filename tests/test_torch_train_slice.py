"""The slices end to end on the CPU: `python -m repro_torch.launch.train`
recovers through the in-memory tier, then through a RAIM5 decode, with
every restored state byte-exact, and finishes with a finite loss — for
opt-125m once with the host encode path and once with the device encode
path forced on (the kernel's plain version, since the state lives on the
CPU), and for mamba2-130m over a sequence of two SSD chunks.

The durable tiers: opt-125m under `objstore` (the same two recoveries,
with shards uploaded to the object store), and under `sync_disk` and
`async_disk` (a software failure restored from disk, byte-exact). Below
RAM, a fresh `objstore` checkpointer of each package (no snapshot in its
SMPs) restores a small numpy state from the `.reft` family of either
package (tier `checkpoint`), then, with every `.reft` file deleted, from
the object store (tier `objstore`), all byte-identical.

A mid-flight software failure under `reft`, in both orders: the failed
member's flight of the newest snapshot landed before the restore read
(tier in-memory) or held in the air by a stopped SMP (tier raim5), and
a round the failed member skipped (tier raim5); the restore records
which, and every restore is byte-exact; `chip_smoke.py`'s rule that
derives the expected tier from that record; its rule that holds a
durable run's persisted steps, the session's closing persist among them,
against the store's families; and a session retrying a cadence persist
that fired no round."""
import glob
import math
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.api import CheckpointSpec as JaxSpec
from repro.api.registry import create_checkpointer as jax_create
from repro.core.treebytes import leaf_arrays as jax_leaf_arrays
from repro_torch import convert
from repro_torch.api import CheckpointSpec
from repro_torch.api.registry import create_checkpointer
from repro_torch.core.treebytes import host_bytes, leaf_arrays

ROOT = Path(__file__).resolve().parents[1]
BOTH = [("in-memory", "True"), ("raim5", "True")]


def _train(tmp_path, arch, seq, device_encode, batch=2, backend="reft",
           inject=("6:software", "10:node"), want=BOTH, extra=()):
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--device", "cpu", "--arch", arch, "--reduced",
           "--steps", "12", "--batch", str(batch), "--seq", str(seq),
           "--backend", backend, "--snapshot-every", "2",
           *(a for i in inject for a in ("--inject", i)),
           "--ckpt-dir", str(tmp_path), *extra,
           "--device-encode", device_encode, "--verify-restores"]
    # one OpenMP thread: the reduced model is tiny, and the suite runs
    # this beside other workers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    out = r.stdout
    tiers = re.findall(r"\[recover\] tier=(\S+) step=\d+ bit_exact=(\S+)",
                       out)
    assert tiers == want, out
    stats = re.search(r"device_encode=(\S+)", out)
    assert stats and stats.group(1) == str(device_encode == "on"), out
    done = re.search(r"\[done\] steps=12 final_loss=(\S+)", out)
    assert done and math.isfinite(float(done.group(1))), out
    return out


@pytest.mark.parametrize("device_encode,arch,extra", [
    pytest.param("auto", "opt-125m", (), id="auto"),
    pytest.param("on", "opt-125m", (), id="on"),
    pytest.param("on", "dbrx-132b", ("--delta",), id="dbrx-132b-delta"),
    pytest.param("on", "jamba-v0.1-52b", ("--delta",), id="jamba-delta")])
def test_train_recovers_through_both_tiers(device_encode, arch, extra,
                                           tmp_path):
    """opt-125m with the host and the device encode path; reduced
    dbrx-132b (every layer MoE) and reduced jamba-v0.1-52b (an SSM layer
    with an MLP, then attention with the MoE) under `--delta`: the
    router's touched-expert mask feeds the dirty provider, which rules
    every byte dirty (the expert leaves are stacked over the layers or
    periods), so every flight is a keyframe and no bucket is skipped."""
    out = _train(tmp_path, arch, 64, device_encode, extra=extra)
    if extra:
        prov = re.search(r"expert_provider calls=(\d+) touched=\[([^]]*)\] "
                         r"dirty_bytes=\[(\d+)\] of (\d+) "
                         r"provider_clean_buckets=(\d+)", out)
        assert prov, out
        touched = [int(t) for t in prov.group(2).split(",")]
        assert len(touched) == int(prov.group(1)) and max(touched) == 4
        assert prov.group(3) == prov.group(4) and prov.group(5) == "0"
        assert re.search(r"delta_flights=0 keyframes=\d+ skipped_buckets=0",
                         out), out


def test_run_frees_its_last_state_without_a_collection(tmp_path,
                                                       monkeypatch):
    """`launch.train.run` under REFT with a mid-flight failure, the
    cyclic collector off: once it returns, no `CheckpointSession` is
    alive and none of the last state's tensors (weak references taken
    as the step returned them): a finished flight drops the leaves it
    pinned."""
    import gc
    import weakref
    from repro_torch.api.session import CheckpointSession
    from repro_torch.launch import train
    from repro_torch.train import steps

    refs = []
    make = steps.make_train_step

    def watched(cfg, *a, **k):
        fn = make(cfg, *a, **k)

        def step(state, batch):
            new, metrics = fn(state, batch)
            refs[:] = [weakref.ref(t) for t in leaf_arrays(new)]
            return new, metrics
        return step

    monkeypatch.setattr(steps, "make_train_step", watched)
    gc.collect()
    gc.disable()
    try:
        rep = train.run(["--device", "cpu", "--arch", "opt-125m", "--reduced",
                         "--steps", "6", "--batch", "2", "--seq", "32",
                         "--snapshot-every", "2", "--inject", "4:software",
                         "--ckpt-dir", str(tmp_path)])
        assert len(rep["losses"]) >= 6 and refs
        alive = [r for r in refs if r() is not None]
        sessions = [o for o in gc.get_objects()
                    if isinstance(o, CheckpointSession)]
    finally:
        gc.enable()
    assert not sessions
    assert not alive, f"{len(alive)} of {len(refs)} leaves alive"


def test_mamba2_train_recovers_through_both_tiers(tmp_path):
    """Reduced mamba2-130m keeps the SSD chunk of 256: 320 tokens make two
    chunks of 160, so the state carried over a chunk boundary is trained
    through, and its fp32 leaves ride in every snapshot and restore."""
    out = _train(tmp_path, "mamba2-130m", 320, "on")
    assert "arch=mamba2-130m-smoke" in out, out


def test_starcoder2_train_recovers_through_both_tiers(tmp_path):
    """Reduced starcoder2-3b (window 64) at seq 2048, the flash threshold:
    every layer's attention runs `swa_flash` (its plain version here)."""
    out = _train(tmp_path, "starcoder2-3b", 2048, "on", batch=1)
    assert "arch=starcoder2-3b-smoke layers=2" in out, out
    assert "batch=1x2048" in out, out


@pytest.mark.parametrize("backend", ["objstore", "sync_disk", "async_disk"])
def test_train_durable_backends_recover(backend, tmp_path):
    if backend == "objstore":
        out = _train(tmp_path, "opt-125m", 64, "auto", backend=backend,
                     extra=("--ckpt-every", "4"))
        up = re.search(r"\[objstore\] uploads=(\S+)MB", out)
        assert up and float(up.group(1)) > 0, out
        assert glob.glob(str(tmp_path / "objstore" / "families" / "step-*"
                             / "MANIFEST.json")), out
    else:
        out = _train(tmp_path, "opt-125m", 64, "auto", backend=backend,
                     inject=("6:software",), want=[("disk", "True")])
        assert glob.glob(str(tmp_path / "ckpt-*-r0.bin")), out


def _numpy_state(seed=0):
    rng = np.random.default_rng(seed)
    import ml_dtypes
    return {"params": {"w": rng.standard_normal((53, 37)).astype(np.float32),
                       "e": rng.standard_normal(3001)
                       .astype(ml_dtypes.bfloat16)},
            "opt_state": {"mu": {"w": rng.standard_normal((53, 37))
                                 .astype(np.float32)}},
            "rng": np.asarray([0, 12345], np.uint32),
            "step": np.asarray(7, np.int32)}


def _flat(tree, leaves):
    """The flat stream of a tree of tensors or of JAX arrays."""
    return np.concatenate([host_bytes(x) for x in leaves(tree)])


def test_ladder_below_ram_matches_reference(tmp_path):
    tree = _numpy_state()
    pkgs = {"jax": (jax_create, JaxSpec, jax_leaf_arrays,
                    jax.tree_util.tree_map(jnp.asarray, tree)),
            "torch": (create_checkpointer, CheckpointSpec, leaf_arrays,
                      convert.state_from_numpy(tree, "cpu"))}
    want = _flat(pkgs["torch"][3], leaf_arrays)
    for name, (create, spec_cls, _, state) in pkgs.items():
        spec = spec_cls(backend="objstore", ckpt_dir=str(tmp_path / name),
                        sg_size=2, options={"scrub_every_s": 0.0})
        with create(spec, state) as ck:
            assert ck.snapshot(state, 7, extra_meta={"ds": 4}, wait=True)
            assert ck.persist(wait=True) == 7
    readers = {}
    try:
        for name, (create, spec_cls, leaves, state) in pkgs.items():
            for wrote in pkgs:
                spec = spec_cls(backend="objstore", sg_size=2,
                                ckpt_dir=str(tmp_path / wrote),
                                options={"scrub_every_s": 0.0})
                readers[name, wrote] = ck = create(spec, state)
                res = ck.restore()
                assert (res.tier, res.step, res.extra_meta) == \
                    ("checkpoint", 7, {"ds": 4}), (name, wrote)
                assert np.array_equal(_flat(res.state, leaves), want)
        for wrote in pkgs:
            for p in glob.glob(str(tmp_path / wrote / "*.reft")):
                os.unlink(p)
        for (name, wrote), ck in readers.items():
            res = ck.restore()
            assert (res.tier, res.step) == ("objstore", 7), (name, wrote)
            assert np.array_equal(_flat(res.state, pkgs[name][2]), want)
    finally:
        for ck in readers.values():
            ck.close()


@pytest.mark.parametrize("order", ["landed", "in-air", "partial"])
def test_software_failure_tier_follows_the_failed_flight(order, tmp_path):
    """Node 0's flight of the newest step lands before the software
    failure ("landed"), or its SMP is stopped (SIGSTOP) so that the flight
    is still in the air when the restore reads ("in-air"), or a step later
    its busy slot skips a round the other members launch ("partial"): the
    restore records each member's clean steps as the ladder read them and
    its flights as its engine saw them, the tier follows, the backend
    reports the partial round as launched, and the restored bytes are the
    newest restorable step's."""
    states = [convert.state_from_numpy(_numpy_state(i), "cpu")
              for i in range(3)]
    spec = CheckpointSpec(backend="reft", ckpt_dir=str(tmp_path), sg_size=4)
    with create_checkpointer(spec, states[0]) as ck:
        assert ck.snapshot(states[0], 2, extra_meta={"ds": 2}, wait=True)
        assert ck.launched(2)
        e0 = ck.group.engines[0]
        pid = e0.smp.proc.pid
        if order != "landed":
            os.kill(pid, signal.SIGSTOP)
        try:
            assert ck.snapshot(states[1], 4, extra_meta={"ds": 4})
            if order == "landed":
                e0.wait()
            if order == "partial":
                for e in ck.group.engines[1:]:
                    e.wait()
                assert not ck.snapshot(states[2], 6, extra_meta={"ds": 6})
                assert ck.launched(6) and not ck.launched(4)
            ck.inject_failure(0, "software")
            res = ck.restore()
        finally:
            if order != "landed":
                os.kill(pid, signal.SIGCONT)
        want = {"landed": (4, "in-memory", [2, 4], [2, 4]),
                "in-air": (4, "raim5", [2], [2, 4]),
                "partial": (6, "raim5", [2], [2, 4, 6])}[order]
        step, tier, own, others = want
        assert res.clean == {0: own, 1: others, 2: others, 3: others}
        assert res.flights == {
            0: {"landed": own, "in_air": [4] if order != "landed" else []},
            **{m: {"landed": others, "in_air": []} for m in (1, 2, 3)}}
        assert (res.tier, res.step, res.extra_meta) == \
            (tier, step, {"ds": step})
        assert np.array_equal(_flat(res.state, leaf_arrays),
                              _flat(states[step // 2 - 1], leaf_arrays))


def _rec(step, tier, clean, landed, in_air=None):
    return {"tier": tier, "step": step, "bit_exact": True, "clean": clean,
            "flights": {m: {"landed": landed[m],
                            "in_air": (in_air or {}).get(m, [])}
                        for m in landed}}


def _rep(first):
    second = _rec(9, "raim5", {0: [5, 7, 9], 2: [5, 7, 9], 3: [5, 7, 9]},
                  {0: [5, 7, 9], 2: [5, 7, 9], 3: [5, 7, 9]})
    return {"recoveries": [first, second]}


ALL = {m: [1, 3] for m in range(4)}


@pytest.mark.parametrize("first,want", [
    (_rec(3, "in-memory", ALL, ALL), "in-memory"),
    # node 0's flight of 3 in the air when the read began
    (_rec(3, "raim5", {**ALL, 0: [1]}, {**ALL, 0: [1]}, {0: [3]}), "raim5"),
    # it landed after the read began: either tier
    (_rec(3, "in-memory", ALL, {**ALL, 0: [1]}, {0: [3]}), "in-memory"),
    # a round only members 0 and 3 launched: step 1 is the newest
    (_rec(1, "in-memory", {0: [1, 6], 1: [1], 2: [1], 3: [1, 6]},
          {0: [1, 6], 1: [1], 2: [1], 3: [1, 6]}), "in-memory"),
    # faults the rule must catch: a snapshot that node 0's engine saw land
    # is missing from its SMP; a rollback past a step that landed on every
    # member; a restore at another step than the newest held
    (_rec(3, "raim5", {**ALL, 0: [1]}, ALL), "lands"),
    (_rec(1, "in-memory", {m: [1] for m in range(4)},
          {m: [1, 3] for m in range(4)}), "lands"),
    (_rec(1, "in-memory", ALL, ALL), "restored step"),
])
def test_chip_smoke_first_tier_follows_the_record(first, want, monkeypatch):
    """chip_smoke.py's phase-4 rule on a run's restore records: the tier
    follows the engines' record of which flights landed before the read,
    held against the SMPs' read; a lost snapshot, a rollback past a
    landed step, or a restore without the record fails."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    if want in ("in-memory", "raim5"):
        assert chip_smoke._want_tiers(_rep(first), "t") == \
            [(want, True), ("raim5", True)]
    else:
        with pytest.raises(AssertionError, match=want if want != "lands"
                           else "saw step 3 land"):
            chip_smoke._want_tiers(_rep(first), "t")
    bare = _rep(first)
    del bare["recoveries"][0]["flights"]
    with pytest.raises(AssertionError, match="no record"):
        chip_smoke._want_tiers(bare, "t")


@pytest.mark.parametrize("stats,persisted,fams,fails", [
    # every cadence round failed or fired nothing: the closing one counts
    ({"persist_upload_bytes": 7}, [11], [11], None),
    ({"persist": 2, "persist_upload_bytes": 7}, [1, 10, 12], [10, 12], None),
    ({"persist_upload_bytes": 7}, [], [11], r"persisted steps \[\]"),
    ({"persist_upload_bytes": 7}, [10], [10, 12], r"not persisted: \[12\]"),
    ({}, [11], [11], "uploads None"),
    ({"persist_upload_bytes": 7}, [11], [], r"manifest \[\]"),
])
def test_chip_smoke_persist_rule(stats, persisted, fams, fails, monkeypatch):
    """chip_smoke.py's phase-5 rule on a durable run's report and store:
    a round persisted (the closing persist counted), bytes uploaded, and
    every family in the store one the run reports persisted."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    rep = {"stats": stats, "persisted_steps": persisted}
    if fails is None:
        chip_smoke._persists_held(rep, set(fams), "t")
    else:
        with pytest.raises(AssertionError, match=fails):
            chip_smoke._persists_held(rep, set(fams), "t")


def test_objstore_run_reports_its_closing_persist(tmp_path, monkeypatch):
    """`launch.train.run` under `objstore` reports the step of every
    persist that completed, the session's closing persist (of the last
    snapshot, landed by then) the newest; every family in the store
    is one of them, as chip_smoke.py's phase-5 rule holds."""
    from repro_torch.launch import train
    from repro_torch.store import LocalObjectStore, object_families
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    rep = train.run(["--device", "cpu", "--arch", "opt-125m", "--reduced",
                     "--steps", "6", "--batch", "2", "--seq", "32",
                     "--backend", "objstore", "--ckpt-every", "4",
                     "--snapshot-every", "2", "--verify-restores",
                     "--ckpt-dir", str(tmp_path)])
    fams = object_families(LocalObjectStore(str(tmp_path / "objstore")),
                           "families")
    assert rep["persisted_steps"][-1] == max(rep["snapshot_crcs"]), rep
    assert len(rep["persisted_steps"]) == rep["stats"].get("persist", 0) + 1
    chip_smoke._persists_held(rep, fams, "t")


@pytest.mark.parametrize("backend,fired", [("reft", [3, 4, 8]),
                                           ("null", [3, 7]),
                                           ("sync_disk", [3, 7])])
def test_session_retries_a_persist_that_fired_nothing(backend, fired,
                                                      tmp_path):
    """Under REFT, a cadence persist that fires no round (no step clean on
    every member yet) is tried again at the next step, and one that fires
    starts the next cadence; backends whose persist cannot defer (null,
    the disk baselines) keep the reference's cadence."""
    from repro_torch.api import CheckpointSession
    state = convert.state_from_numpy(_numpy_state(), "cpu")
    spec = CheckpointSpec(backend=backend, ckpt_dir=str(tmp_path),
                          sg_size=2, snapshot_every_steps=100,
                          checkpoint_every_steps=4)
    calls = []
    with CheckpointSession(spec, state) as sess:
        def persist(*args, **kwargs):
            calls.append(step)
            return None if len(calls) == 1 else step
        sess.checkpointer.persist = persist
        for step in range(1, 10):
            sess.after_step(state, step)
    assert calls == fired
