"""Elastic coordinator (paper §4.2 "Elastic Functionality").

State machine per node: HEALTHY -> SNAP (snapshotting) -> HEALTHY;
UNHEALTHY = software failure (trainer lost, SMP alive);
OFFLINE  = node failure (SMP + memory gone).

`ReftGroup` drives one SG (n members) from a synchronous training loop —
the paper's setting: all DP members snapshot the same iteration.  Each
member owns a real SMP process; snapshotting runs in parallel member
threads (the simulated analogue of parallel per-host PCIe links).
"""
from __future__ import annotations

import enum
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.policy import FrequencyPlan, plan_frequencies
from repro_torch.core.recovery import (
    RecoveryError, restore_from_checkpoint, restore_state,
)
from repro_torch.core.snapshot import ReftConfig, SnapshotEngine


class NodeState(enum.Enum):
    HEALTHY = "HEALTHY"
    SNAP = "SNAP"
    UNHEALTHY = "UNHEALTHY"      # software failure: trainer gone, SMP alive
    OFFLINE = "OFFLINE"          # node failure: SMP and its memory gone


class ReftGroup:
    """REFT for one sharding group of `n` members."""

    def __init__(self, n: int, state_template: Any,
                 cfg: Optional[ReftConfig] = None):
        # NB: a `cfg=ReftConfig()` default would be evaluated once at class
        # definition, making every default-constructed group share one
        # run_id (and thus one set of shm segments) — construct per call.
        cfg = cfg if cfg is not None else ReftConfig()
        self.n, self.cfg = n, cfg
        self.run = cfg.run_id
        self.engines = [SnapshotEngine(i, n, state_template, cfg,
                                       run_id=self.run) for i in range(n)]
        self.template = state_template
        self.total_bytes = self.engines[0].spec.total_bytes
        self.states = {i: NodeState.HEALTHY for i in range(n)}
        self.last_load_stats = None           # LoadStats of the last recover
        self._snapshots_since_ckpt = 0
        # async REFT-Ckpt rounds in flight: {"step", "parts": [(engine,
        # seq)], "t0"}; completed per-engine records keyed by (node, seq)
        self._persist_rounds: List[dict] = []
        self._persist_done: Dict[Tuple[int, int], dict] = {}
        os.makedirs(cfg.ckpt_dir, exist_ok=True)

    # ------------------------------------------------------------- save
    def snapshot(self, state: Any, step: int, extra_meta: dict = None,
                 wait: bool = True) -> bool:
        """All members snapshot iteration `step` in parallel (async).

        The list comprehension is deliberate: a short-circuiting all(gen)
        would stop asking members after the first refusal, leaving the SG
        with a partially-initiated snapshot round."""
        started = all([e.snapshot_async(state, step, extra_meta)
                       for e in self.engines
                       if self.states[e.node] == NodeState.HEALTHY])
        if wait:
            self.wait()
        return started

    def wait(self, timeout: float = 300.0) -> int:
        """Drive every member's pipeline to completion under one shared
        deadline (the members' flights run concurrently, so the budget is
        for the whole SG, not per member)."""
        deadline = time.monotonic() + timeout
        steps = []
        for e in self.engines:
            if self.states[e.node] != NodeState.HEALTHY:
                continue
            steps.append(e.wait(max(0.001, deadline - time.monotonic())))
        self._snapshots_since_ckpt += 1
        if self._snapshots_since_ckpt >= self.cfg.checkpoint_every_snapshots:
            self.checkpoint()
        return min(steps) if steps else -1

    def level_seconds(self) -> Dict[str, float]:
        """Aggregate per-level pipeline timing across members (HASC):
        l1 = device reads (+stall = scratch-credit waits), l2 = staging
        ring writes, l3 = SMP signaling + clean-ack."""
        out = {"l1": 0.0, "l1_stall": 0.0, "l2": 0.0, "l3": 0.0}
        for e in self.engines:
            out["l1"] += e.stats.get("l1_seconds", 0.0)
            out["l1_stall"] += e.stats.get("l1_stall_seconds", 0.0)
            out["l2"] += e.stats.get("l2_seconds", 0.0)
            out["l3"] += e.stats.get("l3_seconds", 0.0)
        return out

    def checkpoint_async(self, remote: Optional[dict] = None,
                         delta_base: Optional[int] = None
                         ) -> Optional[int]:
        """REFT-Ckpt, overlapped: every healthy SMP persists its shard on
        its own background thread (no trainer involvement, no trainer
        blocking).  All members persist the SAME step — the newest one
        every healthy member holds clean — so the on-disk family is
        SG-consistent and restorable.  Returns the step fired (a round
        ticket); collect with `poll_persists` / `drain_persists`.
        `remote` ({store, prefix, retry}) additionally mirrors each shard
        to the object store under `<prefix>/step-<S>/node-<N>.reft`.

        `delta_base` requests a DELTA round against an already-persisted
        step: each member writes only the bytes its flights touched since
        (`step-<S>-from-<B>-node-<N>.reftd`).  All-or-nothing — if any
        member cannot produce a chain from `delta_base` to the chosen
        step (keyframe crossed, log trimmed, engine restarted), the whole
        round falls back to full shards, keeping families uniform."""
        from repro_torch.core.recovery import attach_survivors, common_step
        healthy = [e for e in self.engines
                   if self.states[e.node] == NodeState.HEALTHY
                   and not e.degraded]
        self._snapshots_since_ckpt = 0
        if not healthy:
            return None
        # newest step clean on EVERY healthy member (the 3-buffer rotation
        # means members that skipped a round still hold older clean steps)
        views = attach_survivors(self.run, [e.node for e in healthy],
                                 self.n, self.total_bytes)
        try:
            step = common_step(views)
        finally:
            for v in views.values():
                v.close()
        if step is None or step < 0:
            return None
        base = None
        if delta_base is not None and int(delta_base) < step:
            base = int(delta_base)
            if any(e.delta_extents_since(base, step) is None
                   for e in healthy):
                base = None                      # fall back to full shards
        parts = []
        for e in healthy:
            if base is not None:
                path = os.path.join(
                    self.cfg.ckpt_dir,
                    f"step-{step}-from-{base}-node-{e.node}.reftd")
            else:
                path = os.path.join(self.cfg.ckpt_dir,
                                    f"step-{step}-node-{e.node}.reft")
            rnode = None
            if remote:
                from repro_torch.store.manifest import delta_shard_key, shard_key
                rnode = {k: v for k, v in remote.items() if k != "prefix"}
                prefix = remote.get("prefix", "")
                rnode["key"] = (
                    delta_shard_key(prefix, step, base, e.node)
                    if base is not None else
                    shard_key(prefix, step, e.node))
            parts.append((e, e.persist_async(path, step=step, remote=rnode,
                                             delta_base=base)))
        self._persist_rounds.append({"step": step, "parts": parts,
                                     "t0": time.monotonic(),
                                     "base_step": base})
        return step

    def _fold_round(self, rnd: dict) -> Optional[dict]:
        """Round -> completion record once every member's record is in."""
        recs = [self._persist_done.get((e.node, seq))
                for e, seq in rnd["parts"]]
        if any(r is None for r in recs):
            return None
        for e, seq in rnd["parts"]:
            self._persist_done.pop((e.node, seq), None)
        errors = [f"node{e.node}: {r['error']}"
                  for (e, _), r in zip(rnd["parts"], recs) if r["error"]]
        uploads = {e.node: r["upload"]
                   for (e, _), r in zip(rnd["parts"], recs)
                   if r.get("upload")}
        out = {"step": rnd["step"], "ok": not errors, "errors": errors,
               "seconds": time.monotonic() - rnd["t0"]}
        base = rnd.get("base_step")
        out["kind"] = "delta" if base is not None else "full"
        if base is not None:
            out["base_step"] = base
        if uploads:
            out["uploads"] = uploads
        return out

    def poll_persists(self) -> List[dict]:
        """Non-blocking: completion records ({step, ok, errors, seconds})
        of every REFT-Ckpt round whose members have all finished."""
        for e in self.engines:
            for rec in e.poll_persists():
                self._persist_done[(e.node, rec["seq"])] = rec
        out = []
        keep = []
        for rnd in self._persist_rounds:
            folded = self._fold_round(rnd)
            if folded is None:
                keep.append(rnd)
            else:
                out.append(folded)
        self._persist_rounds = keep
        return out

    def persist_inflight(self) -> int:
        return len(self._persist_rounds)

    def drain_persists(self, timeout: float = 120.0) -> List[dict]:
        """Join every outstanding REFT-Ckpt round (oldest first) under one
        shared deadline."""
        deadline = time.monotonic() + timeout
        out = self.poll_persists()
        while self._persist_rounds:
            rnd = self._persist_rounds[0]
            for e, seq in rnd["parts"]:
                if (e.node, seq) in self._persist_done:
                    continue
                if not e.has_persist_ticket(seq):   # collected or lost
                    self._persist_done[(e.node, seq)] = {
                        "seq": seq, "path": None, "step": rnd["step"],
                        "seconds": 0.0, "error": "persist record lost"}
                    continue
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"REFT-Ckpt round for step {rnd['step']} still in "
                        f"flight after {timeout:.1f}s")
                self._persist_done[(e.node, seq)] = e.persist_join(seq, left)
            out += self.poll_persists()
        return out

    def checkpoint(self, timeout: float = 120.0) -> Optional[int]:
        """Blocking REFT-Ckpt (fire + drain); raises when the fired
        round's persists failed."""
        step = self.checkpoint_async()
        if step is None:
            return None
        rounds = self.drain_persists(timeout)
        mine = next((r for r in rounds if r["step"] == step), None)
        if mine is not None and not mine["ok"]:
            raise RuntimeError(
                f"REFT-Ckpt persist failed: {'; '.join(mine['errors'])}")
        return step

    # ---------------------------------------------------------- failure
    def inject_software_failure(self, node: int):
        """Trainer process dies; SMP and its segments survive."""
        self.states[node] = NodeState.UNHEALTHY

    def inject_node_failure(self, node: int):
        """Whole node dies: SMP killed, volatile memory wiped."""
        e = self.engines[node]
        e.smp.kill()
        from repro_torch.core.smp import ReadOnlyNode
        ReadOnlyNode.unlink_node(self.run, node)
        self.states[node] = NodeState.OFFLINE

    # ---------------------------------------------------------- recover
    def recover(self, target=None) -> Tuple[Any, int, dict, str]:
        """Returns (state, step, extra_meta, tier) per the 3-tier policy.
        `target` (a `repro_torch.api.RestoreTarget`) restricts the load plan;
        the per-phase `LoadStats` of the last recover is kept on
        `self.last_load_stats`."""
        from repro_torch.api.backends import reft_recovery_ladder
        alive = [i for i in range(self.n)
                 if self.states[i] != NodeState.OFFLINE]
        res = reft_recovery_ladder(self.run, self.n, self.total_bytes,
                                   self.template, alive, self.cfg.ckpt_dir,
                                   target=target)
        self.last_load_stats = res.load
        return res.state, res.step, res.extra_meta, res.tier

    def heal(self, node: int):
        """Elastic replacement node rejoins (new SMP).  A degraded member
        (its SMP died under it) needs a respawn just like an offline one —
        as does one whose SMP is dead but not yet *noticed* (killed between
        snapshots, so no send ever raised and `degraded` never flipped)."""
        e = self.engines[node]
        if self.states[node] == NodeState.OFFLINE or e.degraded \
                or not e.smp.alive():
            try:
                e.close()                     # drop stale segments/handles
            except Exception:
                pass
            self.engines[node] = SnapshotEngine(
                node, self.n, self.template, self.cfg, run_id=self.run)
        self.states[node] = NodeState.HEALTHY

    def close(self):
        for e in self.engines:
            try:
                e.close()
            except Exception:
                pass


class Reft:
    """User-facing per-trainer facade: policy-scheduled REFT-Sn + REFT-Ckpt.

    With ``auto=True`` it implements Appendix A's adaptive policy: it
    benchmarks the observed per-step compute time and per-snapshot saving
    time, derives the effective overhead (Eq. 8) and the optimal snapshot
    interval (Eq. 9 with the single-node failure rate), and re-tunes
    ``snapshot_every`` on the fly.

    >>> reft = Reft(group, auto=True, lam_node=1e-4)
    >>> for step, batch in enumerate(data):
    ...     state, _ = train_step(state, batch)
    ...     reft.maybe_snapshot(state, step, extra_meta=data.state())
    """

    def __init__(self, group: ReftGroup, plan: FrequencyPlan = None,
                 snapshot_every: int = 1, *, auto: bool = False,
                 lam_node: float = 1e-4, warmup: int = 4):
        self.group = group
        self.plan = plan
        self.snapshot_every = snapshot_every
        self.auto = auto
        self.lam_node = lam_node
        self.warmup = warmup
        self._last = -1
        self._last_call_t: Optional[float] = None
        self._step_times: List[float] = []

    def _retune(self):
        from repro_torch.core.policy import (effective_save_overhead,
                                       optimal_interval)
        stats = [e.stats for e in self.group.engines
                 if e.stats["snapshots"] > 0]
        if not stats or len(self._step_times) < self.warmup:
            return
        t_comp = sum(self._step_times[-self.warmup:]) / self.warmup
        t_sn = max(s["seconds"] / s["snapshots"] for s in stats)
        o_save = effective_save_overhead(t_sn, t_comp)
        t_opt = optimal_interval(o_save, self.lam_node)
        # interval in steps; o_save==0 -> snapshot every step (Figure 4)
        self.snapshot_every = max(1, int(t_opt / max(t_comp, 1e-9)))

    def maybe_snapshot(self, state, step, extra_meta=None, wait=False):
        now = time.time()
        if self._last_call_t is not None:
            self._step_times.append(now - self._last_call_t)
        self._last_call_t = now
        if self.auto:
            self._retune()
        if step - self._last >= self.snapshot_every:
            if self.group.snapshot(state, step, extra_meta, wait=wait):
                self._last = step
                return True
        return False
