"""The port's save and restore paths against the JAX package's, on the same
state bytes:

  * `ReftGroup(4)` in both packages publishes identical own and parity
    regions and identical metadata (spec JSON, step, extra, `crc_*`
    digests) for every member, with the device encode off and on (on the
    CPU, "on" runs the kernel's plain version in the port and the
    interpret-mode Pallas kernel in the reference).  The run id names the
    shared-memory segments and is not part of the compared bytes; the
    metadata holds no timestamps;
  * the persisted `.reft` files are byte-identical, and each package
    restores the other's — from disk and from shared memory, with one
    member lost and RAIM5-decoded;
  * a snapshot launched at step t and drained after more train steps
    publishes step t's bytes (the port's train step is out of place);
  * the device encoder, over every bucket of the SG members' fused
    schedules, gives what gathering the bucket's bytes and encoding them
    gives, digests equal to zlib's.
"""
import os
import pickle
import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.core.coordinator import ReftGroup as JaxGroup
from repro.core.loader import LoadStats as JaxLoadStats
from repro.core.recovery import restore_from_checkpoint as jax_restore_ckpt
from repro.core.smp import ReadOnlyNode as JaxView
from repro.core.snapshot import ReftConfig as JaxConfig
from repro.core.treebytes import make_flat_spec as jax_spec
from repro.core.treebytes import tree_to_buffer as jax_to_buffer
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import raim5
from repro_torch.core.coordinator import ReftGroup
from repro_torch.core.loader import LoadStats
from repro_torch.core.pipeline import DeviceEncoder, build_schedule
from repro_torch.core.recovery import restore_from_checkpoint, restore_state
from repro_torch.core.smp import NodeLayout, ReadOnlyNode
from repro_torch.core.snapshot import ReftConfig, SnapshotEngine
from repro_torch.core.treebytes import (host_bytes, leaf_arrays,
                                        make_flat_spec, tree_to_buffer)
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.kernels import stage
from repro_torch.configs.base import InputShape
from repro_torch.train.steps import init_train_state, make_train_step

N = 4
STEP = 2


def _numpy_state(seed=0):
    """Odd leaf sizes in every dtype a train state holds."""
    rng = np.random.default_rng(seed)
    import ml_dtypes
    return {
        "params": {"w": rng.standard_normal((37, 29)).astype(np.float32),
                   "e": rng.standard_normal(1001).astype(ml_dtypes.bfloat16)},
        "opt_state": {"mu": {"w": rng.standard_normal((37, 29))
                             .astype(np.float32)},
                      "step": np.asarray(3, np.int32)},
        "rng": np.asarray([0, 12345], np.uint32),
        "step": np.asarray(7, np.int32),
    }


def _flat(spec_fn, buf_fn, tree):
    spec = spec_fn(tree)
    buf = np.zeros(spec.total_bytes, np.uint8)
    buf_fn(tree, spec, buf)
    return buf


def _probe(view_cls, run, total):
    out = []
    for node in range(N):
        v = view_cls(run, node, N, total)
        try:
            out.append((v.read_own(STEP).tobytes(),
                        v.read_parity(STEP).tobytes(),
                        pickle.loads(v.meta(STEP))))
        finally:
            v.close()
    return out


@pytest.mark.parametrize("mode", ["off", "on"])
def test_group_regions_meta_and_files_match_reference(mode, tmp_path):
    np_state = _numpy_state()
    jstate = jax.tree.map(jnp.asarray, np_state)
    tstate = convert.state_from_numpy(np_state, device="cpu")
    kw = dict(bucket_bytes=4096, stage_slots=4, device_encode=mode,
              checkpoint_every_snapshots=10 ** 6)
    jg = JaxGroup(N, jstate, JaxConfig(ckpt_dir=str(tmp_path / "jax"), **kw))
    tg = ReftGroup(N, tstate, ReftConfig(ckpt_dir=str(tmp_path / "torch"),
                                         **kw))
    try:
        assert tg.engines[0].stats["device_encode"] == (mode == "on")
        assert jg.snapshot(jstate, STEP, extra_meta={"k": 1})
        assert tg.snapshot(tstate, STEP, extra_meta={"k": 1})
        assert tg.total_bytes == jg.total_bytes
        want = _probe(JaxView, jg.run, jg.total_bytes)
        got = _probe(ReadOnlyNode, tg.run, tg.total_bytes)
        for node, (w, g) in enumerate(zip(want, got)):
            assert g[0] == w[0], f"node {node}: own region differs"
            assert g[1] == w[1], f"node {node}: parity region differs"
            assert g[2] == w[2], f"node {node}: meta differs"
        assert "crc_own" in got[0][2] and "crc_stripes" in got[0][2]

        # in-memory, across packages: the port reads the reference's
        # shared memory with member 1 lost (RAIM5 decode)
        info = {}
        tree, step, extra = restore_state(jg.run, N, jg.total_bytes, tstate,
                                          [0, 2, 3], info=info)
        assert (step, extra, info["missing"]) == (STEP, {"k": 1}, [1])
        assert np.array_equal(_flat(make_flat_spec, tree_to_buffer, tree),
                              _flat(jax_spec, jax_to_buffer, jstate))

        # REFT-Ckpt files: byte-identical, and each package restores the
        # other's family
        assert jg.checkpoint() == STEP and tg.checkpoint() == STEP
        names = sorted(os.listdir(tmp_path / "jax"))
        assert names == sorted(os.listdir(tmp_path / "torch"))
        for name in names:
            assert (tmp_path / "jax" / name).read_bytes() == \
                (tmp_path / "torch" / name).read_bytes(), name
    finally:
        jg.close()
        tg.close()
    want = _flat(jax_spec, jax_to_buffer, jstate)
    tree, step, _ = restore_from_checkpoint(str(tmp_path / "jax"), N, tstate)
    assert step == STEP
    assert np.array_equal(_flat(make_flat_spec, tree_to_buffer, tree), want)
    tree, step, _ = jax_restore_ckpt(str(tmp_path / "torch"), N, jstate)
    assert np.array_equal(_flat(jax_spec, jax_to_buffer, tree), want)
    # a member's shard corrupted on disk: CRC demotion, RAIM5 decode
    lost = [n for n in names if "node-2" in n]
    assert lost
    for family in ("jax", "torch"):
        _flip_own_bytes(tmp_path / family / lost[0])
    st = LoadStats()
    tree, step, _ = restore_from_checkpoint(str(tmp_path / "jax"), N, tstate,
                                            stats=st)
    assert st.decoded_bytes > 0
    assert np.array_equal(_flat(make_flat_spec, tree_to_buffer, tree), want)
    st = JaxLoadStats()
    tree, step, _ = jax_restore_ckpt(str(tmp_path / "torch"), N, jstate,
                                     stats=st)
    assert st.decoded_bytes > 0
    assert np.array_equal(_flat(jax_spec, jax_to_buffer, tree), want)


def _flip_own_bytes(path, nbytes=16):
    """Corrupt the start of a `.reft` shard's own region (just past the
    pickled head), so its own-region digest fails."""
    with open(path, "rb") as f:
        pickle.load(f)
        off = f.tell()
    with open(path, "r+b") as f:
        f.seek(off)
        chunk = bytes(b ^ 0xFF for b in f.read(nbytes))
        f.seek(off)
        f.write(chunk)


def test_snapshot_in_flight_keeps_step_t_while_training(tmp_path):
    cfg = get_config("opt-125m").reduced()
    state = init_train_state(cfg, 0, device="cpu")
    step_fn = make_train_step(cfg)
    ds = SyntheticDataset(cfg, InputShape("t", 32, 2, "train"), seed=0,
                          device="cpu")
    state, _ = step_fn(state, next(ds))
    want = b"".join(host_bytes(x).tobytes() for x in leaf_arrays(state))
    eng = SnapshotEngine(0, 1, state, ReftConfig(
        bucket_bytes=1 << 16, ckpt_dir=str(tmp_path), scratch_buffers=1,
        checkpoint_every_snapshots=10 ** 6))
    try:
        assert eng.snapshot_async(state, 1)
        for _ in range(3):                     # training moves on meanwhile
            state, _ = step_fn(state, next(ds))
        assert eng.wait() == 1
        view = ReadOnlyNode(eng.run, 0, 1, eng.spec.total_bytes)
        try:
            got = view.read_own(1).tobytes()
        finally:
            view.close()
    finally:
        eng.close()
    assert got == want
    newest = b"".join(host_bytes(x).tobytes() for x in leaf_arrays(state))
    assert newest != want


def _encode_every_bucket(state, bucket_bytes):
    """Every bucket of the SG members' fused schedules through the device
    encoder, against its gathered bytes and zlib. -> (kinds, tasks with
    no byte of the state)."""
    spec = make_flat_spec(state)
    enc = DeviceEncoder(spec, leaf_arrays(state))
    lay = NodeLayout(N, spec.total_bytes)
    kinds, in_pad = set(), 0
    for node in range(N):
        own = [(i * lay.bs, *ref.byte_range(lay.bs, N)) for i, ref in
               enumerate(raim5.data_blocks_of_node(node, N))]
        stripe = [ref.byte_range(lay.bs, N)
                  for ref in raim5.parity_stripe_of_node(node, N)]
        for task in build_schedule(spec, own, stripe, bucket_bytes,
                                   fuse_parity=True):
            srcs = task.sources or ((task.lo, task.hi),)
            for want in (None, True):
                lanes, crc, nb = enc.encode(task, want_crc=want)
                rows = np.stack([enc.gather_bytes(a, b).numpy()
                                 for a, b in srcs])
                folded = np.bitwise_xor.reduce(rows, axis=0)
                assert nb == task.hi - task.lo
                assert np.array_equal(lanes.numpy(), folded)
                digests = crc.numpy().view(np.uint32)
                if task.kind == 0 or want:
                    assert enc.bucket_crc(digests, nb) == \
                        zlib.crc32(folded[:nb].tobytes())
                else:
                    assert not digests.any()
            kinds.add(task.kind)
            in_pad += all(a >= spec.total_bytes for a, _ in srcs)
    assert stage.encode_bucket.launches == 0
    return kinds, in_pad


def test_device_encoder_matches_gather_for_every_bucket():
    cfg = get_config("opt-125m").reduced()
    state = init_train_state(cfg, 0, device="cpu")
    kinds, _ = _encode_every_bucket(state, 1 << 18)
    assert kinds == {0, 2}


def test_device_encoder_encodes_buckets_wholly_in_the_pad():
    # 13 bytes over 12 RAIM5 blocks of 2 bytes: the last 5 blocks lie in
    # the pad past total_bytes, so their 5 own buckets, and the parity
    # bucket of the stripe of the last 3, have no leaf slice
    state = convert.state_from_numpy(
        {"a": np.arange(2, dtype=np.float32) + 1.5,
         "b": np.arange(5, dtype=np.uint8) + 7}, device="cpu")
    kinds, in_pad = _encode_every_bucket(state, 1 << 18)
    assert kinds == {0, 2} and in_pad == 6


@pytest.mark.parametrize("device_encode", ["off", "on"])
def test_multi_flight_overlap_matches_reference(device_encode):
    """max_flights=2: flight N+1 launches while N drains, a third is
    refused over the credit; both packages publish the same bytes for both
    steps, keep the shared scratch pool whole, and restore step 2."""
    rng = np.random.default_rng(4)
    st1 = {"opt_mu": np.zeros(1 << 15, np.float32),
           "w": rng.standard_normal(1 << 15).astype(np.float32)}
    st2 = {k: v + np.float32(1) for k, v in st1.items()}
    kw = dict(bucket_bytes=1 << 12, stage_slots=4, max_flights=2,
              scratch_buffers=2, device_encode=device_encode)
    out = {}
    for pkg in ("jax", "torch"):
        conv = (lambda t: jax.tree.map(jnp.asarray, t)) if pkg == "jax" \
            else (lambda t: convert.state_from_numpy(t, device="cpu"))
        if pkg == "jax":
            from repro.core.recovery import restore_state as restore
            from repro.core.snapshot import SnapshotEngine as Engine
            cfg, view_cls = JaxConfig(**kw), JaxView
        else:
            restore, Engine = restore_state, SnapshotEngine
            cfg, view_cls = ReftConfig(**kw), ReadOnlyNode
        eng = Engine(0, 1, conv(st1), cfg)
        try:
            assert eng.snapshot_async(conv(st1), 1)
            assert eng.snapshot_async(conv(st2), 2)     # overlapped launch
            assert not eng.snapshot_async(conv(st2), 3)  # over the credit
            assert eng.wait() == 2
            assert eng.stats["snapshots"] == 2
            assert eng.stats["overlapped_flights"] >= 1
            pool = eng._pipeline
            assert pool._free.qsize() == pool.scratch_buffers
            total = eng.spec.total_bytes
            rec, step, _ = restore(eng.run, 1, total, conv(st1), [0])
            view = view_cls(eng.run, 0, 1, total)
            try:
                assert {1, 2} <= set(view.clean_steps())
                out[pkg] = (step, _flat_any(rec),
                            [(view.read_own(s).tobytes(),
                              pickle.loads(view.meta(s))) for s in (1, 2)])
            finally:
                view.close()
        finally:
            eng.close()
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 2
    want = np.concatenate([st2["opt_mu"].view(np.uint8),
                           st2["w"].view(np.uint8)]).tobytes()
    assert out["torch"][1] == want
    assert out["torch"][2][0][0][:len(want)] == np.concatenate(
        [st1["opt_mu"].view(np.uint8), st1["w"].view(np.uint8)]).tobytes()


def _flat_any(tree):
    """The flat stream of a restored tree of either package."""
    return b"".join(host_bytes(x).tobytes() for x in leaf_arrays(tree))
