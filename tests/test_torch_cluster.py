"""The port's `LocalCluster` (`repro_torch.core.cluster`): real node
processes, each a numpy trainer with a real `SnapshotEngine` whose SMP is
a further child; faults are SIGKILLs and unlinked shared memory.

  * the deterministic trainer (`make_state`, `update_state`, `state_at`)
    gives the JAX package's bytes, leaf for leaf (exact);
  * the software, node, double-failure and SMP-only cases of
    `tests/test_cluster_integration.py` recover bit-exact in the port;
  * the `.reft` family the port's cluster persists is restored by the
    JAX package's loader, byte-identical to the oracle.
"""
import numpy as np
import pytest

from repro.core.cluster import make_state as jax_make_state
from repro.core.cluster import state_at as jax_state_at
from repro.core.cluster import update_state as jax_update_state
from repro.core.recovery import restore_from_checkpoint as jax_restore_ckpt
from repro.core.treebytes import leaf_arrays as jax_leaf_arrays
from repro_torch.core.cluster import (LocalCluster, make_state, state_at,
                                      update_state)
from repro_torch.core.treebytes import host_bytes, leaf_arrays, treedef_repr
from repro_torch.supervise import trees_equal


def _same_bytes(got, want):
    lg, lw = leaf_arrays(got), jax_leaf_arrays(want)
    return len(lg) == len(lw) and all(
        np.asarray(w).dtype.name == np.asarray(g).dtype.name
        and host_bytes(g).tobytes() == np.asarray(w).tobytes()
        for g, w in zip(lg, lw))


@pytest.mark.parametrize("seed,nbytes", [(0, 1 << 12), (11, 1 << 15),
                                         (5, 1000)])
def test_trainer_bytes_match_reference(seed, nbytes):
    got, want = make_state(seed, nbytes), jax_make_state(seed, nbytes)
    assert treedef_repr(got) == treedef_repr(want)
    assert _same_bytes(got, want)
    for step in range(1, 5):
        got, want = update_state(got, step), jax_update_state(want, step)
        assert _same_bytes(got, want)
    assert _same_bytes(state_at(seed, 6, nbytes), jax_state_at(seed, 6,
                                                               nbytes))


@pytest.fixture
def cluster(tmp_path):
    c = LocalCluster(4, seed=11, nbytes=1 << 15, snapshot_every=1,
                     ckpt_dir=str(tmp_path))
    yield c
    c.close()


def test_software_failure_inmemory_resume(cluster):
    c = cluster
    c.run_rounds(4)
    c.kill_trainer(2)                       # SIGKILL; SMP orphaned alive
    state, step, tier = c.recover()
    assert tier == "in-memory" and step == 4
    assert trees_equal(state, c.expected_state(step))
    c.restart_node(2, state)
    c.run_rounds(2)                         # cluster proceeds healthily
    assert c.nodes[2].last_step == 6


def test_node_failure_raim5_decode(cluster):
    c = cluster
    c.run_rounds(3)
    c.kill_node(1)                          # trainer+SMP dead, memory wiped
    state, step, tier = c.recover()
    assert tier == "raim5" and step == 3
    assert trees_equal(state, c.expected_state(step))


def test_double_failure_falls_back_to_ckpt(cluster):
    c = cluster
    c.run_rounds(3)
    c.checkpoint()
    c.run_rounds(2)
    c.kill_node(0)
    c.kill_node(3)
    state, step, tier = c.recover()
    assert tier == "checkpoint" and step == 3     # ckpt taken at step 3
    assert trees_equal(state, c.expected_state(step))
    # the family the port's nodes persisted, read by the JAX package
    tree, at, _ = jax_restore_ckpt(c.ckpt_dir, 4, jax_make_state(11, 1 << 15))
    assert at == 3
    assert _same_bytes(state, tree)
    assert _same_bytes(state_at(11, 3, 1 << 15), tree)


def test_smp_only_crash_keeps_training(cluster):
    """SMP dies but trainer lives: training continues; protection is
    degraded until heal (we just assert no training disruption)."""
    c = cluster
    c.run_rounds(2)
    c.kill_smp(3)
    c.run_rounds(2)                          # rounds still complete
    assert all(np_.last_step == 4 for np_ in c.nodes.values())
