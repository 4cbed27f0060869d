"""Multi-stage (3D-parallel) REFT: one sharding group per pipeline stage.

The paper's full setting: the model is cut into `n_pp` stage slices; all
DP replicas of one stage form an SG ("all PP_0 nodes formulate SG_0",
Fig. 5).  Each SG protects *its stage's* slice independently, so failures
in different stages recover concurrently, and a single node loss per SG —
up to one per stage simultaneously — is decodable.

`MultiStageGroup` composes per-stage `ReftGroup`s over a stage-partitioned
train state.  Stage slicing is by the flat byte stream (same machinery as
SG-internal sharding), which mirrors how PP assigns contiguous layer
blocks to stages.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.coordinator import NodeState, ReftGroup
from repro_torch.core.snapshot import ReftConfig
from repro_torch.core.treebytes import (leaf_arrays, make_flat_spec,
                                        tree_unflatten)


def split_state_by_stage(state: Any, n_pp: int) -> List[Dict]:
    """Partition the pytree's leaves into n_pp contiguous groups of
    roughly equal bytes (PP layer assignment analogue).

    Returns per-stage {"leaves": {idx: array}} trees; leaf indices refer
    to the flatten order (JAX's, as the port's treebytes walks it) so the
    full state can be reassembled and the stage boundaries equal the JAX
    package's.
    """
    flat = leaf_arrays(state)
    sizes = [ls.nbytes for ls in make_flat_spec(state).leaves]
    total = sum(sizes)
    target = total / n_pp
    stages: List[Dict] = [{} for _ in range(n_pp)]
    acc, si = 0.0, 0
    for i, (leaf, sz) in enumerate(zip(flat, sizes)):
        if acc >= target * (si + 1) and si < n_pp - 1:
            si += 1
        stages[si][f"leaf{i:04d}"] = leaf
        acc += sz
    return stages


def join_stages(template: Any, stage_trees: List[Dict]) -> Any:
    out = list(leaf_arrays(template))
    for st in stage_trees:
        for key, leaf in st.items():
            out[int(key[4:])] = leaf
    return tree_unflatten(template, out)


class MultiStageGroup:
    """REFT over an n_pp x dp grid of simulated nodes (one SG per stage)."""

    def __init__(self, n_pp: int, dp: int, state_template: Any,
                 cfg: Optional[ReftConfig] = None):
        # NB: a `cfg=ReftConfig()` default would be evaluated once at class
        # definition — every default-constructed grid would share one
        # run_id (one shm namespace); construct a fresh config per call.
        cfg = cfg if cfg is not None else ReftConfig()
        self.n_pp, self.dp = n_pp, dp
        self.template = state_template
        self.last_load_stats = None   # per-stage LoadStats of last recover
        self.last_tiers = None        # per-stage tiers of the last recover
        self.stage_templates = split_state_by_stage(state_template, n_pp)
        self.groups: List[ReftGroup] = []
        for s, st in enumerate(self.stage_templates):
            scfg = dataclasses.replace(
                cfg, run_id=f"{cfg.run_id}-pp{s}",
                ckpt_dir=f"{cfg.ckpt_dir}/pp{s}")
            self.groups.append(ReftGroup(dp, st, scfg))

    def snapshot(self, state: Any, step: int, extra_meta: dict = None,
                 wait: bool = True) -> bool:
        """Launch every stage's per-member pipelines first (all SGs' L1
        pumps overlap), then optionally drain them under one deadline."""
        stage_states = split_state_by_stage(state, self.n_pp)
        ok = True
        for g, st in zip(self.groups, stage_states):
            ok &= g.snapshot(st, step, extra_meta, wait=False)
        if wait:
            self.wait()
        return ok

    def wait(self, timeout: float = 300.0) -> int:
        """Drain all stages' in-flight pipelines; the shared deadline spans
        the whole grid since the flights run concurrently.  Returns the min
        consistent step across stages (-1 when nothing completed)."""
        deadline = time.monotonic() + timeout
        steps = [g.wait(max(0.001, deadline - time.monotonic()))
                 for g in self.groups]
        return min(steps) if steps else -1

    def level_seconds(self) -> Dict[str, float]:
        out = {"l1": 0.0, "l1_stall": 0.0, "l2": 0.0, "l3": 0.0}
        for g in self.groups:
            for k, v in g.level_seconds().items():
                out[k] += v
        return out

    def checkpoint(self):
        for g in self.groups:
            g.checkpoint()

    def inject_node_failure(self, stage: int, member: int):
        self.groups[stage].inject_node_failure(member)

    def inject_software_failure(self, stage: int, member: int):
        self.groups[stage].inject_software_failure(member)

    def recover(self, target=None) -> Tuple[Any, int, str]:
        """Stage-local recovery; the restart step is the min consistent
        step across stages (synchronous training keeps them equal).  Each
        stage's SG runs its own `LoadPlan` (ranged parallel reads +
        range-limited decode); the per-stage `LoadStats` land in
        `self.last_load_stats` and the per-stage tiers in
        `self.last_tiers` (lists, one per stage)."""
        stage_states = []
        steps = []
        tiers = []
        self.last_load_stats = []
        for g in self.groups:
            st, step, _, tier = g.recover(target=target)
            stage_states.append(st)
            steps.append(step)
            tiers.append(tier)
            self.last_load_stats.append(getattr(g, "last_load_stats", None))
        self.last_tiers = tiers
        assert len(set(steps)) == 1, f"stage steps diverged: {steps}"
        worst = max(tiers, key=["in-memory", "raim5", "checkpoint"].index)
        return join_stages(self.template, stage_states), steps[0], worst

    def heal_all(self):
        for g in self.groups:
            for i in range(self.dp):
                g.heal(i)
            g.states = {i: NodeState.HEALTHY for i in range(self.dp)}

    def close(self):
        for g in self.groups:
            g.close()
