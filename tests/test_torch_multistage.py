"""The port's one-SG-per-pipeline-stage layout (`repro_torch.core.
multistage`, the paper's Fig. 5) against the JAX package's, on the same
state bytes; every comparison is exact:

  * `split_state_by_stage` gives the reference's `leaf{i:04d}` keys and
    stage boundaries, and `join_stages` reassembles the state;
  * a snapshot publishes, in every stage's SG, the reference's own and
    parity regions and metadata, member for member;
  * one node lost in every stage at once, and a mixed-tier loss (one
    stage in memory, the other past RAIM5 to its `.reft` family), both
    recover byte-exact, with each stage's tier recorded.
"""
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.core.multistage import MultiStageGroup as JaxStages
from repro.core.multistage import split_state_by_stage as jax_split
from repro.core.smp import ReadOnlyNode as JaxView
from repro.core.snapshot import ReftConfig as JaxConfig
from repro_torch import convert
from repro_torch.core.multistage import (MultiStageGroup, join_stages,
                                         split_state_by_stage)
from repro_torch.core.smp import ReadOnlyNode
from repro_torch.core.snapshot import ReftConfig
from repro_torch.supervise import trees_equal

STEP = 1


def numpy_state(seed=0):
    """Blocks of unequal sizes and every dtype a train state holds."""
    import ml_dtypes
    rng = np.random.default_rng(seed)
    return {
        "blk0": {"w": rng.standard_normal((64, 64)).astype(np.float32)},
        "blk1": {"w": rng.standard_normal((48, 64)).astype(np.float32),
                 "b": rng.standard_normal(64).astype(ml_dtypes.bfloat16)},
        "blk2": {"w": rng.standard_normal((64, 32)).astype(np.float32)},
        "blk3": {"w": rng.standard_normal((64, 64)).astype(np.float32)},
        "head": rng.standard_normal((64, 128)).astype(ml_dtypes.bfloat16),
        "rng": np.asarray([0, 7], np.uint32),
        "step": np.asarray(0, np.int32),
    }


@pytest.mark.parametrize("n_pp", [1, 2, 3, 4])
def test_split_matches_reference_and_joins_back(n_pp):
    np_state = numpy_state()
    state = convert.state_from_numpy(np_state, device="cpu")
    got = split_state_by_stage(state, n_pp)
    want = jax_split(jax.tree.map(jnp.asarray, np_state), n_pp)
    assert [sorted(st) for st in got] == [sorted(st) for st in want]
    assert all(len(st) > 0 for st in got)
    assert trees_equal(join_stages(state, got), state)
    for g, w in zip(got, want):
        assert trees_equal(g, {k: np.asarray(v) for k, v in w.items()})


def _cfg(cls, tmp_path, pkg):
    return cls(ckpt_dir=str(tmp_path / pkg), bucket_bytes=4096,
               stage_slots=4, checkpoint_every_snapshots=10 ** 6)


def _probe(view_cls, group):
    out = []
    for s, g in enumerate(group.groups):
        for node in range(group.dp):
            v = view_cls(g.run, node, group.dp, g.total_bytes)
            try:
                out.append((s, node, v.read_own(STEP).tobytes(),
                            v.read_parity(STEP).tobytes(),
                            pickle.loads(v.meta(STEP))))
            finally:
                v.close()
    return out


def test_stage_smp_bytes_match_reference(tmp_path):
    dp = 3
    np_state = numpy_state(1)
    jg = JaxStages(2, dp, jax.tree.map(jnp.asarray, np_state),
                   _cfg(JaxConfig, tmp_path, "jax"))
    tstate = convert.state_from_numpy(np_state, device="cpu")
    tg = MultiStageGroup(2, dp, tstate, _cfg(ReftConfig, tmp_path, "torch"))
    try:
        jg.snapshot(jax.tree.map(jnp.asarray, np_state), STEP,
                    extra_meta={"k": 1})
        tg.snapshot(tstate, STEP, extra_meta={"k": 1})
        want, got = _probe(JaxView, jg), _probe(ReadOnlyNode, tg)
        assert len(got) == 2 * dp
        for w, g in zip(want, got):
            assert g[:2] == w[:2]
            assert g[2] == w[2], f"stage {g[0]} member {g[1]}: own differs"
            assert g[3] == w[3], f"stage {g[0]} member {g[1]}: parity"
            assert g[4] == w[4], f"stage {g[0]} member {g[1]}: meta"
    finally:
        jg.close()
        tg.close()


def test_concurrent_single_failures_across_stages(tmp_path):
    """One node loss in EVERY stage simultaneously is still recoverable
    (RAIM5 protects one per SG, and SGs are per stage)."""
    s = convert.state_from_numpy(numpy_state(2), device="cpu")
    g = MultiStageGroup(2, 3, s, ReftConfig(ckpt_dir=str(tmp_path),
                                            checkpoint_every_snapshots=10**6))
    try:
        g.snapshot(s, 1)
        g.inject_node_failure(0, 1)
        g.inject_node_failure(1, 2)     # a second loss, different SG
        rec, step, tier = g.recover()
        assert tier == "raim5" and step == 1
        assert g.last_tiers == ["raim5", "raim5"]
        assert trees_equal(rec, s)
    finally:
        g.close()


def test_mixed_tier_recovery(tmp_path):
    s = convert.state_from_numpy(numpy_state(3), device="cpu")
    g = MultiStageGroup(2, 3, s, ReftConfig(ckpt_dir=str(tmp_path),
                                            checkpoint_every_snapshots=10**6))
    try:
        g.snapshot(s, 1)
        g.checkpoint()
        g.inject_software_failure(0, 0)         # stage 0: in-memory
        g.inject_node_failure(1, 0)             # stage 1: raim5
        g.inject_node_failure(1, 1)             # stage 1: second loss -> ckpt
        rec, step, tier = g.recover()
        assert tier == "checkpoint" and step == 1
        assert g.last_tiers == ["in-memory", "checkpoint"]
        assert trees_equal(rec, s)
    finally:
        g.close()
