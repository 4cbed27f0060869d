"""Supervisor loop: failures are routine, training is forever.

`Supervisor` owns the training loop a driver would otherwise run inline:
it advances steps through a caller-supplied `advance` function, drives a
`CheckpointSession`'s cadence, fires planned fault `Scenario`s (mid-flight
when non-graceful), *detects* each fault via `health()` / preempt ticks /
a CRC integrity probe, and recovers — heal-in-place through the recovery
ladder with bounded-backoff retries, or an elastic n→m session rebuild
when a preemption shrinks the group.  Every restore is checked byte-exact
against an oracle ring of states remembered at snapshot steps, every
wall-clock second lands in exactly one `GoodputLedger` bucket, and
observed failures/restore costs feed the session's MTBF-driven cadence
tuner through a shared `FailureObserver`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.api import CheckpointSession, CheckpointSpec
from repro_torch.core.policy import FailureObserver
from repro_torch.core.recovery import (
    RecoveryError, attach_survivors, verify_crc,
)
from repro_torch.core.treebytes import (dtype_name, host_bytes, leaf_arrays,
                                        tensor_u8, tree_map, treedef_repr)
from repro_torch.supervise.goodput import GoodputLedger
from repro_torch.supervise.inject import FAILURE_KINDS, Scenario

#: kinds detectable by polling health() until the member reads bad
_HEALTH_KINDS = frozenset({"software", "node", "smp"})


def _copy_leaf(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()         # stays on the leaf's device
    return np.array(x, copy=True)


def _copy_tree(tree):
    return tree_map(_copy_leaf, tree)


def _on_card(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_cuda


def _same_bytes(x, y) -> bool:
    """Byte equality of two leaves; on the card when either lives there
    (a restored host tree against a device oracle moves to the card)."""
    if not (_on_card(x) or _on_card(y)):
        return np.array_equal(host_bytes(x), host_bytes(y))
    dev = x.device if _on_card(x) else y.device
    bx, by = (tensor_u8(t.detach()).to(dev) if isinstance(t, torch.Tensor)
              else torch.from_numpy(host_bytes(t).copy()).to(dev)
              for t in (x, y))
    return torch.equal(bx, by)


def trees_equal(a, b) -> bool:
    """Same structure, and every leaf pair has the same shape, dtype and
    bytes (so bf16 leaves and -0.0 compare exactly); torch leaves on any
    device and numpy leaves compare alike, in JAX's flatten order."""
    if treedef_repr(a) != treedef_repr(b):
        return False
    la, lb = leaf_arrays(a), leaf_arrays(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if tuple(x.shape) != tuple(y.shape) \
                or dtype_name(x) != dtype_name(y):
            return False
        if not _same_bytes(x, y):
            return False
    return True


class Supervisor:
    """Run `advance` for `total_steps` under fault injection + auto-heal.

    advance(state, step) -> state   one training step (deterministic for
                                    byte-exact verification to mean much)

    Scenario dispatch:
      software / node / smp   inject -> poll health -> ladder restore,
                              retried with exponential backoff
      corrupt-stripe          inject -> drain + CRC-probe every CLEAN
                              buffer -> evict the corrupt member ->
                              RAIM5 restore decodes it from parity
      preempt                 inject -> use the grace window to drain +
                              persist a durable family -> wait out the
                              reclaim -> heal-in-place, or (with a
                              `new_sg` param) elastic n→m rebuild: a
                              fresh session restores the family
                              resharded onto m members
      laggard / slow-persist  perf faults: recorded, survived, and (for
                              slow-persist) latency reset after
                              `duration_steps`; nothing to restore

    The `observer` (shared across elastic rebuilds) carries measured
    failure arrivals and restore costs into `CheckpointSession._retune`.
    """

    def __init__(self, spec: CheckpointSpec, template: Any,
                 advance: Callable[[Any, int], Any], *,
                 scenarios: Optional[List[Scenario]] = None,
                 retries: int = 3, backoff_s: float = 0.1,
                 detect_timeout_s: float = 10.0,
                 oracle_keep: int = 16,
                 observer: Optional[FailureObserver] = None,
                 ledger: Optional[GoodputLedger] = None,
                 on_event: Optional[Callable] = None,
                 log: Callable[[str], None] = lambda s: None):
        self.spec = spec
        self.template = template
        self.advance = advance
        self.scenarios = sorted(scenarios or [], key=lambda s: s.step)
        self.retries = max(1, retries)
        self.backoff_s = backoff_s
        self.detect_timeout_s = detect_timeout_s
        self.oracle_keep = oracle_keep
        self.observer = observer or FailureObserver()
        self.ledger = ledger or GoodputLedger()
        self.on_event = on_event
        self.log = log
        self.sess: Optional[CheckpointSession] = None
        self.events: List[dict] = []
        self.unrecovered = 0
        self._oracle: dict = {}           # step -> state copy (bounded ring)
        self._step_cost: dict = {}        # step -> compute seconds
        self._slow_resets: List[tuple] = []   # (due_step, node, old_delay)
        self.cadence: List[list] = []     # [step, snapshot_every, ckpt_every]

    # ------------------------------------------------------------ oracle
    def _remember(self, state, step: int):
        self._oracle[step] = _copy_tree(state)
        for s in sorted(self._oracle)[:-self.oracle_keep]:
            del self._oracle[s]

    def _bit_exact(self, res) -> Optional[bool]:
        ref = self._oracle.get(res.step)
        if ref is None:
            return None                   # restored past the oracle ring
        return trees_equal(res.state, ref)

    # ------------------------------------------------------------ events
    def _record(self, **kw):
        self.events.append(kw)
        self.ledger.record_event(**kw)
        if self.on_event:
            self.on_event(kw)

    # ----------------------------------------------------------- healing
    def _restore_with_backoff(self) -> tuple:
        """(RestoreResult, attempts) — bounded-backoff retry around the
        ladder; raises the last error when the budget is exhausted."""
        last = None
        for attempt in range(self.retries):
            try:
                return self.sess.restore(), attempt + 1
            except (RecoveryError, OSError, RuntimeError) as e:
                last = e
                self.log(f"[supervisor] restore attempt {attempt + 1}/"
                         f"{self.retries} failed: {e}")
                time.sleep(self.backoff_s * (2 ** attempt))
                # a durable round may have landed since the failure but
                # its manifest only commits on a poll — without this the
                # checkpoint tier can stay invisible across every retry
                try:
                    self.sess.checkpointer.poll_persists()
                except Exception:
                    pass
        raise last

    def _probe_corruption(self) -> List[int]:
        """Drain in-flight saves, then CRC-verify EVERY clean buffer of
        every attachable member (corruption may sit on a non-latest
        buffer of the 3-slot rotation).  Returns the corrupt members."""
        self.sess.wait()
        g = self.sess.checkpointer.group
        from repro_torch.core.coordinator import NodeState
        nodes = [i for i in range(g.n)
                 if g.states[i] != NodeState.OFFLINE]
        views = attach_survivors(g.run, nodes, g.n, g.total_bytes)
        bad = []
        try:
            for node, v in views.items():
                for s in v.clean_steps():
                    if not verify_crc(v, s, g.n, g.total_bytes):
                        bad.append(node)
                        break
        finally:
            for v in views.values():
                v.close()
        return bad

    def _wait_unhealthy(self, node: int) -> float:
        """Poll health() until `node` reads bad; returns detection lag."""
        t0 = time.monotonic()
        deadline = t0 + self.detect_timeout_s
        while time.monotonic() < deadline:
            h = self.sess.health()
            if node in h["degraded"] or node in h.get("preempted", []):
                return time.monotonic() - t0
            # health() is a pull API over the sim cluster; detection-
            # lag measurement needs a fine poll  # analyze: ok ANZ007
            time.sleep(0.01)
        raise RuntimeError(f"node {node} never detected unhealthy "
                           f"within {self.detect_timeout_s}s")

    def _rollback(self, res, cur_step: int) -> None:
        """Re-attribute compute seconds of steps the restore rolled back."""
        lost = sum(dt for s, dt in self._step_cost.items()
                   if res.step < s <= cur_step)
        if lost:
            self.ledger.transfer("compute", "lost_steps", lost)
        for s in list(self._step_cost):
            if s > res.step:
                del self._step_cost[s]

    # ------------------------------------------------- per-kind recovery
    def _heal_in_place(self, sc: Scenario, cur_step: int) -> tuple:
        """(new_state, new_step) after a ladder restore + heal, verified
        byte-exact against the oracle ring."""
        detect_s = (self._wait_unhealthy(sc.node)
                    if sc.kind in _HEALTH_KINDS or sc.kind == "preempt"
                    else 0.0)
        evicted = []
        if sc.kind == "corrupt-stripe":
            t0 = time.monotonic()
            evicted = self._probe_corruption()
            detect_s = time.monotonic() - t0
            for node in evicted:
                self.sess.checkpointer.evict(node)
        self.ledger.mark("detect")
        t0 = time.monotonic()
        try:
            res, attempts = self._restore_with_backoff()
        except Exception as e:
            self.ledger.mark("restore")
            self.unrecovered += 1
            self._record(kind=sc.kind, node=sc.node, fired_step=sc.step,
                         graceful=sc.graceful, recovered=False,
                         error=f"{type(e).__name__}: {e}")
            import traceback
            self.log(f"[supervisor] UNRECOVERED {sc.kind}@node{sc.node}: "
                     f"{traceback.format_exc()}")
            return None, cur_step
        restore_s = time.monotonic() - t0
        exact = self._bit_exact(res)
        self._rollback(res, cur_step)
        self.ledger.mark("restore")
        self._record(kind=sc.kind, node=sc.node, fired_step=sc.step,
                     graceful=sc.graceful, recovered=True,
                     detect_s=detect_s, restore_s=restore_s,
                     tier=res.tier, restored_step=res.step,
                     rolled_back=cur_step - res.step, attempts=attempts,
                     bit_exact=exact, evicted=evicted or None)
        self.log(f"[supervisor] healed {sc.kind}@node{sc.node}: "
                 f"tier={res.tier} step={res.step} "
                 f"bit_exact={exact} detect={detect_s:.3f}s "
                 f"restore={restore_s:.3f}s")
        return res.state, res.step

    def _preempt(self, sc: Scenario, state, cur_step: int) -> tuple:
        """Spot reclaim: persist inside the grace window, then heal in
        place or rebuild the session elastically onto `new_sg` members."""
        params = sc.merged_params()
        new_sg = params.get("new_sg")
        # use the grace window: a durable family survives the reclaim
        # even if the in-memory tier does not
        self.sess.drain()
        try:
            self.sess.persist()
        except Exception as e:            # grace persist is best-effort
            self.log(f"[supervisor] grace-window persist failed: {e}")
        self.ledger.mark("checkpoint_stall")
        detect_s = self._wait_unhealthy(sc.node)   # grace expiry tick
        self.ledger.mark("detect")
        if not new_sg or new_sg == self.spec.sg_size:
            # replacement hardware shows up: ladder restore + heal
            t0 = time.monotonic()
            res, attempts = self._restore_with_backoff()
            restore_s = time.monotonic() - t0
            exact = self._bit_exact(res)
            self._rollback(res, cur_step)
            self.ledger.mark("restore")
            self._record(kind="preempt", node=sc.node, fired_step=sc.step,
                         graceful=sc.graceful, recovered=True,
                         detect_s=detect_s, restore_s=restore_s,
                         tier=res.tier, restored_step=res.step,
                         rolled_back=cur_step - res.step,
                         attempts=attempts, bit_exact=exact)
            self.log(f"[supervisor] healed preempt@node{sc.node}: "
                     f"tier={res.tier} step={res.step} bit_exact={exact}")
            return res.state, res.step
        # elastic n->m: tear down, rebuild smaller, restore resharded
        t0 = time.monotonic()
        old_sg = self.spec.sg_size
        self.sess.close(final_persist=False)
        self.spec = dataclasses.replace(self.spec, sg_size=int(new_sg),
                                        resume=True, run_id=None)
        self.sess = CheckpointSession(self.spec, self.template,
                                      observer=self.observer)
        self.sess.__enter__()
        res = self.sess.restored
        if res is None:
            self.ledger.mark("restore")
            self.unrecovered += 1
            self._record(kind="preempt", node=sc.node, fired_step=sc.step,
                         graceful=sc.graceful, recovered=False,
                         error="elastic rebuild found nothing to restore")
            return None, cur_step
        restore_s = time.monotonic() - t0
        exact = self._bit_exact(res)
        self._rollback(res, cur_step)
        self.ledger.mark("restore")
        self._record(kind="preempt", node=sc.node, fired_step=sc.step,
                     graceful=sc.graceful, recovered=True,
                     detect_s=detect_s, restore_s=restore_s,
                     tier=res.tier, restored_step=res.step,
                     rolled_back=cur_step - res.step,
                     elastic=f"{old_sg}->{new_sg}", bit_exact=exact)
        self.log(f"[supervisor] elastic reshard {old_sg}->{new_sg}: "
                 f"tier={res.tier} step={res.step} bit_exact={exact}")
        return res.state, res.step

    def _perf_fault(self, sc: Scenario, cur_step: int):
        """laggard / slow-persist: inject, remember the remediation.

        A laggard additionally runs a VERIFICATION restore through the
        straggler-aware read scheduler while the member is stopped: no
        state is adopted (the trainer never lost anything), but the
        restore must come back bit-exact and its wall clock / tier land
        in the fault event — this is exactly the window where adaptive
        scheduling (work stealing, parity reroute) earns its keep, and
        the restore's LoadStats feed the observer's bandwidth priors.
        Disable with scenario param verify_restore=False.
        """
        params = sc.merged_params()
        verify_restore = bool(params.pop("verify_restore", True))
        if sc.kind == "slow-persist":
            node = sc.node % self.spec.sg_size
            e = self.sess.checkpointer.group.engines[node]
            old = e.persist_delay_s
            due = cur_step + int(params.pop("duration_steps", 3))
            self._slow_resets.append((due, node, old))
        self.sess.inject(sc.kind, node=sc.node % self.spec.sg_size,
                         graceful=sc.graceful, **params)
        extra = {}
        if sc.kind == "laggard" and verify_restore:
            t0 = time.monotonic()
            try:
                res, attempts = self._restore_with_backoff()
            except Exception as e:
                self.log(f"[supervisor] laggard verification restore "
                         f"failed: {e}")
                self.unrecovered += 1
                extra = {"restore_s": time.monotonic() - t0,
                         "recovered": False}
            else:
                ld = res.load
                extra = {"restore_s": time.monotonic() - t0,
                         "tier": res.tier, "attempts": attempts,
                         "bit_exact": self._bit_exact(res),
                         "sched": getattr(ld, "sched", "") if ld else "",
                         "stolen_chunks": getattr(ld, "stolen_chunks", 0)
                         if ld else 0}
            self.ledger.mark("restore")
        self._record(kind=sc.kind, node=sc.node, fired_step=sc.step,
                     graceful=sc.graceful, perf_only=True,
                     **{"recovered": True, **extra},
                     **{k: v for k, v in params.items()
                        if isinstance(v, (int, float))})

    def _tick_slow_resets(self, cur_step: int):
        """Supervisor-side remediation of slow-persist: latency injected
        for a bounded window, then restored to the configured value."""
        for due, node, old in list(self._slow_resets):
            if cur_step >= due:
                try:
                    g = self.sess.checkpointer.group
                    g.engines[node].persist_delay_s = old
                except Exception:
                    pass
                self._slow_resets.remove((due, node, old))

    def _note_cadence(self, step: int):
        """Record the session's cadence (snapshot / checkpoint interval in
        steps) whenever it changes, e.g. when `auto_tune` retunes it."""
        now = [step, self.sess.snapshot_every, self.sess.checkpoint_every]
        if not self.cadence or self.cadence[-1][1:] != now[1:]:
            self.cadence.append(now)

    # -------------------------------------------------------------- run
    def run(self, total_steps: int, state: Optional[Any] = None) -> dict:
        pending = list(self.scenarios)
        state = state if state is not None else _copy_tree(self.template)
        self.sess = CheckpointSession(self.spec, self.template,
                                      observer=self.observer)
        self.sess.__enter__()
        if self.sess.restored is not None:
            state = self.sess.restored.state
        step = 0
        self.ledger.mark("overhead")
        try:
            while step < total_steps:
                state = self.advance(state, step + 1)
                step += 1
                self._step_cost[step] = self.ledger.mark("compute")
                self.sess.after_step(state, step)
                self.ledger.mark("checkpoint_stall")
                self._note_cadence(step)
                self._remember(state, step)
                self._tick_slow_resets(step)
                self.ledger.mark("overhead")

                while pending and pending[0].step <= step:
                    sc = pending.pop(0)
                    node = sc.node % self.spec.sg_size
                    sc = dataclasses.replace(sc, node=node)
                    self.log(f"[supervisor] inject {sc.kind}@node{node} "
                             f"step={step}"
                             + ("" if sc.graceful else " (mid-flight)"))
                    if sc.kind in ("laggard", "slow-persist"):
                        self._perf_fault(sc, step)
                        self.ledger.mark("overhead")
                        continue
                    params = sc.merged_params()
                    params.pop("new_sg", None)
                    self.sess.inject(sc.kind, node=node,
                                     graceful=sc.graceful, **params)
                    self.ledger.mark("overhead")
                    if sc.kind == "preempt":
                        new_state, step = self._preempt(sc, state, step)
                    else:
                        new_state, step = self._heal_in_place(sc, step)
                    if new_state is not None:
                        state = new_state
            self.sess.drain()
            self.ledger.mark("checkpoint_stall")
        finally:
            try:
                self.sess.close()
            finally:
                self.ledger.close()
        failures = [e for e in self.events
                    if e["kind"] in FAILURE_KINDS]
        return {
            "steps": total_steps,
            "final_state": state,
            "events": list(self.events),
            "injected": len(self.events),
            "failures": len(failures),
            "kinds": sorted({e["kind"] for e in self.events}),
            "unrecovered": self.unrecovered,
            "bit_exact_checks": [e.get("bit_exact") for e in failures],
            "cadence": list(self.cadence),
            "mtbf_s": self.observer.mtbf(),
            "lam_node_posterior": self.observer.lam_node(
                prior=self.spec.lam_node, n=self.spec.sg_size),
            "goodput": self.ledger.summary(),
        }
