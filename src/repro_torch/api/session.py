"""CheckpointSession — the lifecycle object training loops actually hold.

Owns everything the training loops used to hand-wire individually:
  * run-id allocation (one id per session unless the spec pins one);
  * snapshot / checkpoint cadence in steps, including the Appendix-A
    adaptive policy (`auto_tune=True` re-derives the optimal snapshot
    interval from measured per-step compute and per-snapshot saving time,
    subsuming the old inline `FrequencyPlan` wiring);
  * degraded-mode handling — a lost fault-tolerance sidecar must never
    kill training: degradation is surfaced as events + `health()`, and the
    loop keeps running;
  * restore-on-entry — `with CheckpointSession(...) as sess:` resumes from
    whatever the backend can reconstruct (`sess.restored`), so a relaunched
    job continues instead of restarting;
  * a final drain + persist on clean exit.

Typical loop:

    spec = CheckpointSpec(backend="reft", ckpt_dir=..., sg_size=4)
    with CheckpointSession(spec, state_template) as sess:
        if sess.restored:
            state, step = sess.restored.state, sess.restored.step
        while step < total:
            state, metrics = train_step(state, batch)
            sess.after_step(state, step, extra_meta=ds.state())
"""
from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Sequence

from repro_torch.api.types import (
    Checkpointer, CheckpointSpec, CkptEvent, RestoreResult, RestoreTarget,
)
from repro_torch.core.pipeline import step_boundary
from repro_torch.core.recovery import RecoveryError
from repro_torch.core.spans import span


class CheckpointSession:
    def __init__(self, spec: CheckpointSpec, state_template: Any, *,
                 on_event: Optional[Callable[[CkptEvent], None]] = None,
                 restore_target: Optional[RestoreTarget] = None,
                 observer: Optional[Any] = None):
        if spec.run_id is None:
            spec = spec.with_run_id(CheckpointSpec.alloc_run_id())
        self.spec = spec
        # MTBF + restore-cost feedback into the Appendix-A tuner: pass a
        # shared FailureObserver to carry observations across elastic
        # session rebuilds (the supervisor does); default is per-session
        if observer is None:
            from repro_torch.core.policy import FailureObserver
            observer = FailureObserver()
        self.observer = observer
        self.run_id = spec.run_id
        self.checkpointer: Checkpointer = spec.build(state_template)
        self.checkpointer.on_event = on_event
        # hand the observer to the backend so restores can seed the read
        # scheduler's bandwidth priors from cross-restore history
        self.checkpointer.observer = observer
        # restore-on-entry (and every sess.restore()) declares the CURRENT
        # layout so a checkpoint saved under a different sg_size/mesh is
        # resharded by the distributed loader (elastic n->m restart)
        self.restore_target = restore_target or RestoreTarget(
            sg_size=spec.sg_size,
            device_put=bool(spec.options.get("restore_device_put", False)))
        self.restored: Optional[RestoreResult] = None
        self.snapshot_every = max(1, spec.snapshot_every_steps)
        self.checkpoint_every = max(1, spec.checkpoint_every_steps)
        self._last_snapshot = -1
        self._last_persist = -1
        # set by restore() where heal() leaves members without a snapshot
        # (`Checkpointer.snapshot_after_restore`): the next step snapshots
        # whatever the cadence
        self._reprotect = False
        self._last_call_t: Optional[float] = None
        self._step_times: List[float] = []
        self._degraded_seen: set = set()
        # cadence persists fire WITHOUT blocking on disk I/O when the
        # backend supports it (persist(wait=False) tickets); completion
        # is polled alongside snapshot flights in after_step.
        # options["persist_blocking"] forces the old inline behavior.
        self._persist_kwargs: dict = {}
        if not spec.options.get("persist_blocking", False):
            import inspect
            try:
                params = inspect.signature(
                    self.checkpointer.persist).parameters
            except (TypeError, ValueError):
                params = {}
            if "wait" in params:
                self._persist_kwargs = {"wait": False}

    # ----------------------------------------------------------- entry
    def _restore_call(self, step, target) -> RestoreResult:
        import inspect
        try:
            params = inspect.signature(self.checkpointer.restore).parameters
        except (TypeError, ValueError):
            params = {}
        if "target" in params:     # third-party backends may predate it
            return self.checkpointer.restore(step, target=target)
        return self.checkpointer.restore(step)

    def __enter__(self) -> "CheckpointSession":
        if self.spec.resume:
            try:
                self.restored = self._restore_call(None, self.restore_target)
            except (RecoveryError, FileNotFoundError):
                self.restored = None
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close(final_persist=exc_type is None)
        return False

    def close(self, final_persist: bool = True):
        try:
            if final_persist:
                try:
                    self.checkpointer.wait()
                    if self._last_snapshot >= 0:
                        self.checkpointer.persist()
                except Exception as e:
                    # fault tolerance must not crash a finished run, but a
                    # failed FINAL persist means the newest durable state
                    # is stale — say so loudly instead of exiting silent
                    import sys
                    print(f"[repro_torch.api] WARNING: final persist failed: "
                          f"{type(e).__name__}: {e}", file=sys.stderr)
        finally:
            self.checkpointer.close()

    # --------------------------------------------------------- cadence
    def after_step(self, state: Any, step: int,
                   extra_meta: dict = None) -> dict:
        """Call once per training step; runs whatever is due.  Returns
        {"snapshot": bool, "launched": bool, "persist": Optional[int]}:
        "launched" also holds for a capture that went out in part
        (`Checkpointer.launched`)."""
        with span("session.after_step"):
            return self._after_step(state, step, extra_meta)

    def _after_step(self, state: Any, step: int, extra_meta: dict) -> dict:
        # tick the HASC gate: in-flight L1 pumps burst at step boundaries
        # instead of racing the forward/backward pass for host bandwidth
        step_boundary()
        now = time.time()
        if self._last_call_t is not None:
            self._step_times.append(now - self._last_call_t)
        self._last_call_t = now
        if self.spec.auto_tune:
            self._retune()

        did = {"snapshot": False, "launched": False, "persist": None}
        if self._reprotect or step - self._last_snapshot >= \
                self.snapshot_every:
            if self.checkpointer.snapshot(state, step, extra_meta):
                self._last_snapshot = step
                self._reprotect = False
                did["snapshot"] = True
            did["launched"] = did["snapshot"] or \
                self.checkpointer.launched(step)
        if step - self._last_persist >= self.checkpoint_every:
            # fire-and-overlap: the SMPs stream their shards to disk in
            # the background; after_step returns without touching disk.
            # Where a round can fire nothing although captures exist
            # (`persist_can_defer`), it is tried again at the next step,
            # as a refused snapshot is, instead of a whole cadence later.
            did["persist"] = self.checkpointer.persist(
                **self._persist_kwargs)
            if did["persist"] is not None or \
                    not self.checkpointer.persist_can_defer:
                self._last_persist = step
        # collect async persists that completed since the last step (the
        # backend emits their `persist` events / commits the manifest)
        self.checkpointer.poll_persists()
        self._watch_degraded(step)
        return did

    def _retune(self):
        """Appendix A (Eqs. 8-11): effective overhead -> optimal intervals,
        converted to steps with the measured compute time."""
        from repro_torch.core.policy import plan_frequencies
        warmup = 4
        if len(self._step_times) < warmup:
            return
        st = self.checkpointer.stats()
        # prefer engine-side timing: with async launches the trainer-side
        # snapshot_seconds is just the (near-zero) thread-start cost, which
        # would make the tuner conclude snapshots are free
        n_snap = st.get("engine_snapshots") or st.get("snapshot", 0)
        if not n_snap:
            return
        t_comp = sum(self._step_times[-warmup:]) / warmup
        t_sn = st.get("engine_seconds",
                      st.get("snapshot_seconds", 0.0)) / n_snap
        t_ck = (st.get("persist_seconds", 0.0) / st["persist"]
                if st.get("persist") else t_sn)
        # closed loop: observed failures move lam off the static prior
        # (Gamma posterior), and observed per-tier restore costs inflate
        # the effective rate — a failure-heavy run snapshots more often,
        # a quiet one relaxes back toward the prior-derived cadence
        lam = self.observer.lam_node(prior=self.spec.lam_node,
                                     n=self.spec.sg_size)
        plan = plan_frequencies(
            t_snapshot=t_sn, t_checkpoint=t_ck,
            t_comp=t_comp, lam_node=lam, n=self.spec.sg_size,
            t_restore_snapshot=self.observer.restore_cost("snapshot"),
            t_restore_checkpoint=self.observer.restore_cost("checkpoint"))
        self.snapshot_every = max(
            1, int(plan.snapshot_interval / max(t_comp, 1e-9)))
        if plan.checkpoint_interval != float("inf"):
            self.checkpoint_every = max(
                self.snapshot_every,
                int(plan.checkpoint_interval / max(t_comp, 1e-9)))

    def _watch_degraded(self, step):
        h = self.checkpointer.health()
        for node in h["degraded"]:
            if node not in self._degraded_seen:
                self._degraded_seen.add(node)

    # ------------------------------------------------ recovery surface
    def restore(self, step: Optional[int] = None,
                target: Optional[RestoreTarget] = None) -> RestoreResult:
        """Run the backend's recovery ladder and heal failed members so
        training can continue with full protection.  `target` overrides
        the session's restore target for this one call (partial loads,
        explicit reshard).

        Under REFT a healed member holds no snapshot, so until one lands
        on every member a second failure elsewhere leaves too few holders
        of any step for a RAIM5 decode.  Unlike the JAX package, whose
        cadence clock runs on (and, after a rollback, stays ahead of the
        replayed steps), the next `after_step` therefore snapshots
        whatever the cadence where the backend says so
        (`Checkpointer.snapshot_after_restore`) — under `auto_tune` the
        interval can outgrow the run."""
        t0 = time.monotonic()
        res = self._restore_call(step, target or self.restore_target)
        self.observer.record_restore(time.monotonic() - t0,
                                     tier=res.tier, load=res.load)
        self.checkpointer.heal()
        self._degraded_seen.clear()
        self._reprotect = self.checkpointer.snapshot_after_restore
        return res

    def inject(self, kind: str, node: int = 0, graceful: bool = True,
               **params):
        """Simulate a failure.  `graceful=True` (the historical behavior)
        drains in-flight saves first, so the fault lands at a quiesced
        step boundary; `graceful=False` injects MID-FLIGHT — whatever
        snapshots/persists are in the air stay in the air, which is what
        real failures look like.  Kind-specific `params` (grace_s, lag_s,
        delay_s, nbytes, seed) pass through to the backend."""
        if graceful:
            self.checkpointer.wait()
        self.checkpointer.inject_failure(node, kind, **params)
        from repro_torch.supervise.inject import FAILURE_KINDS
        if kind in FAILURE_KINDS:      # perf faults aren't MTBF arrivals
            self.observer.record_failure()

    # ------------------------------------------------------ passthrough
    def snapshot(self, state, step, extra_meta=None, wait=False):
        ok = self.checkpointer.snapshot(state, step, extra_meta, wait=wait)
        if ok:
            self._last_snapshot = step
        return ok

    def persist(self, step=None, wait=True):
        # a manual persist resets the cadence clock too (a persist right
        # before a cadence boundary should not be repeated at it)
        self._last_persist = step if step is not None else self._last_snapshot
        if not wait and self._persist_kwargs:
            return self.checkpointer.persist(step, wait=False)
        return self.checkpointer.persist(step)

    def wait(self):
        self.checkpointer.wait()

    def drain(self):
        """Join ALL outstanding async work — in-flight snapshots and
        fired-but-unfinished persists — and collect their events."""
        self.checkpointer.wait()
        self.checkpointer.poll_persists()

    def health(self) -> dict:
        return self.checkpointer.health()

    def stats(self) -> dict:
        return self.checkpointer.stats()

    @property
    def events(self) -> Sequence[CkptEvent]:
        return self.checkpointer.events

    @property
    def degraded(self) -> bool:
        return bool(self._degraded_seen)
