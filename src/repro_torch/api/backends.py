"""Built-in memory-tier backends: `reft` and `null`.

`reft` wraps the paper's full stack behind the uniform `Checkpointer`
protocol: a `ReftGroup` of SnapshotEngines (one real SMP process per SG
member), the three-tier recovery ladder, and `CheckpointManager` retention
(manifest + keep-latest-k GC) for the persisted REFT-Ckpt tier.

`reft_recovery_ladder` is the single implementation of the tier policy —
`ReftGroup.recover`, `LocalCluster.recover`, and the facade all route
through it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional

from repro_torch.api.registry import register_backend
from repro_torch.api.types import (
    Checkpointer, CheckpointSpec, RestoreResult, RestoreTarget,
)
from repro_torch.core.loader import LoadStats, resolve_need
from repro_torch.core.recovery import (
    RecoveryError, restore_from_checkpoint, restore_state,
)


def _target_need(template: Any, target: Optional[RestoreTarget]):
    """RestoreTarget -> (global byte ranges or None, device_put flag).
    The spec is derived from the template, which is layout-identical to
    what was saved (the FlatSpec contract every tier relies on)."""
    if target is None:
        return None, False
    from repro_torch.core.treebytes import make_flat_spec
    need = resolve_need(make_flat_spec(template), target)
    return need, bool(target.device_put)


def reft_recovery_ladder(run: str, n: int, total_bytes: int, template: Any,
                         alive_nodes: List[int], ckpt_dir: str,
                         step: Optional[int] = None,
                         target: Optional[RestoreTarget] = None,
                         store=None, store_prefix: str = "families",
                         store_retry=None, sched=None,
                         info: Optional[dict] = None) -> RestoreResult:
    """Tiered recovery (paper §3 step 5 + the tier-4 remote rung):
      in-memory  — every member's SMP segments reachable, plain reassembly;
      raim5      — exactly one member missing, decode it from parity;
      checkpoint — >1 member gone, reload the last persisted REFT-Ckpt;
      objstore   — local families gone/corrupt too, ranged reads from the
                   object store's manifest-complete families (only when a
                   `store` is configured).

    Every tier routes through the distributed loader's `LoadPlan`
    executors; `target` restricts the plan to the restoring job's layout
    (reshard-on-restore / partial loads) and the returned
    `RestoreResult.load` carries the per-phase `LoadStats`. `info`, when
    given, is filled as `recovery.restore_state` fills it (the members'
    clean steps as the in-memory rungs read them among its keys).
    """
    need, device_put = _target_need(template, target)
    target_n = (target.sg_size if target and target.sg_size else n)
    stats = LoadStats()
    stats.target_n = target_n
    try:
        info = {} if info is None else info
        state, got_step, extra = restore_state(
            run, n, total_bytes, template, alive_nodes, info=info,
            step=step, need=need, device_put=device_put, stats=stats,
            sched=sched)
        # tier reflects what the restore actually did: any member that had
        # to be decoded from parity (gone, corrupt, OR a laggard whose
        # buffers rotated past the chosen step) makes it raim5
        repaired = (info.get("missing", []) or info.get("corrupt", [])
                    or info.get("stale", []))
        stats.tier = "raim5" if repaired else "in-memory"
        stats.saved_n = n
        stats.resharded = stats.target_n != n
        return RestoreResult(state=state, step=got_step, extra_meta=extra,
                             tier=stats.tier, load=stats)
    except RecoveryError:
        pass
    try:
        stats = LoadStats()                    # drop partial tier-1/2 reads
        stats.target_n = target_n
        state, got_step, extra = restore_from_checkpoint(
            ckpt_dir, n, template, step=step, need=need,
            device_put=device_put, stats=stats, sched=sched)
        stats.tier = "checkpoint"
        stats.resharded = stats.saved_n != stats.target_n
        return RestoreResult(state=state, step=got_step, extra_meta=extra,
                             tier="checkpoint", load=stats)
    except RecoveryError:
        if store is None:
            raise
    from repro_torch.core.recovery import restore_from_objstore
    stats = LoadStats()                        # drop partial tier-3 reads
    stats.target_n = target_n
    state, got_step, extra = restore_from_objstore(
        store, store_prefix, n, template, step=step, need=need,
        device_put=device_put, stats=stats, retry=store_retry, sched=sched)
    stats.tier = "objstore"
    stats.resharded = stats.saved_n != stats.target_n
    return RestoreResult(state=state, step=got_step, extra_meta=extra,
                         tier="objstore", load=stats)


class ReftCheckpointer(Checkpointer):
    """REFT behind the facade: async sharded in-memory snapshots (REFT-Sn),
    SMP-side persistence (REFT-Ckpt) with managed retention, ladder
    recovery, real fault injection, and elastic healing."""

    name = "reft"
    persist_can_defer = True
    snapshot_after_restore = True

    def __init__(self, spec: CheckpointSpec, state_template: Any):
        super().__init__(spec)
        from repro_torch.ckpt.manager import CheckpointManager
        from repro_torch.core.coordinator import ReftGroup
        from repro_torch.core.snapshot import ReftConfig, _trace_default

        run_id = spec.run_id or CheckpointSpec.alloc_run_id()
        opt = spec.options
        rcfg = ReftConfig(
            bucket_bytes=spec.bucket_bytes,
            ckpt_dir=spec.ckpt_dir,
            snapshot_every_steps=spec.snapshot_every_steps,
            # the session owns persist cadence; disable the group's own
            checkpoint_every_snapshots=10 ** 9,
            run_id=run_id,
            stage_slots=opt.get("stage_slots", 8),
            # HASC saving-pipeline knobs (docs/API.md "Saving pipeline");
            # pipeline=False keeps the serial pre-refactor thread as the
            # measurable interference baseline
            pipeline=opt.get("pipeline", True),
            prefetch_window=opt.get("prefetch_window", 4),
            scratch_buffers=opt.get("scratch_buffers", 2),
            opt_first=opt.get("opt_first", True),
            yield_every_buckets=opt.get("yield_every_buckets", 4),
            boundary_timeout_s=opt.get("boundary_timeout_s", 0.005),
            # device-side encode + multi-flight (docs/API.md
            # "Device-side encode"): fused CUDA gather+XOR+CRC before
            # d2h, overlapped flights, saving-path CPU pinning
            device_encode=opt.get("device_encode", "auto"),
            max_flights=opt.get("max_flights", 1),
            pin_cpus=opt.get("pin_cpus", "auto"),
            # async-persistence knobs (docs/API.md "Async persistence"):
            # simulated durable-tier latency for tests and the
            # persist-overlap interference benchmark; persist_bw_limit
            # rate-limits the SMP's background writes (+ uploads) so the
            # durable tier cannot starve a co-located trainer of IO
            persist_delay_s=opt.get("persist_delay_s", 0.0),
            persist_bw_limit=opt.get("persist_bw_limit", 0.0),
            # dirty-delta snapshotting (docs/API.md "Delta snapshots &
            # keyframes"): flights re-send only changed buckets, persists
            # write `.reftd` chains against the last persisted step
            delta=opt.get("delta", False),
            delta_keyframe=opt.get("delta_keyframe", 8),
            delta_dirty_threshold=opt.get("delta_dirty_threshold", 0.6),
            delta_digest=opt.get("delta_digest", True),
            # straggler-aware loading (docs/API.md "Straggler-aware
            # loading"): restore-side read scheduler mode and token-bucket
            # rate cap mirroring persist_bw_limit on the write side
            restore_sched=opt.get("restore_sched", "adaptive"),
            restore_bw_limit=opt.get("restore_bw_limit", 0.0),
            # runtime SMP-protocol validation (docs/API.md "Analysis &
            # invariants"); default follows REPRO_TRACE_PROTOCOL so CI
            # turns it on fleet-wide without touching call sites
            trace_protocol=bool(opt.get("trace_protocol",
                                        _trace_default())),
        )
        self.group = ReftGroup(spec.sg_size, state_template, rcfg)
        self.manager = CheckpointManager(spec.ckpt_dir, spec.sg_size,
                                         keep=spec.keep)
        self._degraded_emitted: set = set()
        self._launched: Optional[int] = None   # see launched()
        self._preempts: dict = {}       # node -> monotonic eviction deadline
        self._preempted: list = []      # nodes whose grace window expired
        # optional FailureObserver attached by the session; its learned
        # per-source bandwidths seed the read scheduler's EWMA priors
        self.observer = None

    # ------------------------------------------------------------- save
    def snapshot(self, state, step, extra_meta=None, wait=False):
        self.poll_persists()           # fold finished async persists first
        t0 = time.perf_counter()
        lv0 = self.group.level_seconds() if wait else None
        newest = [e.flights[-1] if e.flights else None
                  for e in self.group.engines]
        started = self.group.snapshot(state, step, extra_meta, wait=wait)
        # the step, when some member launched it (the whole round or part)
        self._launched = step if any(
            e.flights and e.flights[-1] is not newest[i]
            for i, e in enumerate(self.group.engines)) else None
        if started:
            levels = None
            if wait:
                lv1 = self.group.level_seconds()
                levels = {k: lv1[k] - lv0[k] for k in lv1}
            self.emit("snapshot", step, seconds=time.perf_counter() - t0,
                      nbytes=self.group.total_bytes, levels=levels,
                      detail="" if wait else "async-launch")
        self._check_degraded(step)
        return started

    def launched(self, step):
        return self._launched == step

    def set_dirty_provider(self, fn) -> None:
        """Install the delta saving path's dirtiness signal on every
        member engine (e.g. `repro_torch.core.delta.expert_dirty_ranges` over
        the MoE router's touched-expert mask); no-op when `delta` is
        off."""
        for e in self.group.engines:
            e.set_dirty_provider(fn)

    def poll_persists(self):
        """Collect finished REFT-Ckpt rounds: resolve the manager's
        in-flight registration, commit the manifest (+GC), and emit a
        `persist` (or `persist-error`) event per round."""
        self._tick_preempts()
        return self._emit_rounds(self.group.poll_persists())

    def _emit_rounds(self, out):
        for r in out:
            self.manager.resolve_inflight(r["step"])
            if r["ok"]:
                manifest = self.manager.commit()
                detail = f"manifest={manifest['complete_steps']}"
                if r.get("kind") == "delta":
                    detail += f" delta-from-{r['base_step']}"
                self.emit("persist", r["step"], seconds=r["seconds"],
                          detail=detail)
            else:
                # the torn family is left to GC (no longer in-flight);
                # the engine is NOT degraded — a failed durable write
                # must not pause in-memory protection
                self.manager.commit()
                self.emit("persist-error", r["step"], seconds=r["seconds"],
                          detail="; ".join(r["errors"]))
        return out

    def _persist_remote(self) -> Optional[dict]:
        """Tier-4 hook: the `remote` spec ({store, prefix, retry}) each
        persist round mirrors shards under, or None for local-only (this
        base backend).  `ObjStoreCheckpointer` overrides it."""
        return None

    def _delta_base(self) -> Optional[int]:
        """Base step for a delta persist round: the newest fully-landed
        step on EVERY durable tier in play (a local-only base would tear
        the remote chain), or None for a full round.  The coordinator
        still falls back to full shards when any member lacks the flight
        extents, and the engines' snapshot keyframes bound chain length
        (a keyframe in the span voids the chain)."""
        if not self.spec.options.get("delta", False):
            return None
        steps = set(self.manager.complete_steps())
        if self.manager.store is not None:
            steps &= set(self.manager.remote_complete_steps())
        steps -= set(self.manager.inflight_steps())
        return max(steps) if steps else None

    def persist(self, step=None, wait=True):
        """Fire an SG-consistent REFT-Ckpt round.  `wait=False` returns
        the fired step immediately (the SMPs stream their pinned shards
        on background threads); `wait=True` additionally drains the
        freshest snapshot first (so the round captures it) and blocks
        until the family is durable, raising on persist failure."""
        self.poll_persists()
        if wait:
            self.group.wait()          # capture the newest snapshot
        s = self.group.checkpoint_async(remote=self._persist_remote(),
                                        delta_base=self._delta_base())
        if s is None:
            return None
        self.manager.register_inflight(s)
        if wait:
            rounds = self._emit_rounds(self.group.drain_persists())
            mine = next((r for r in rounds if r["step"] == s), None)
            if mine is not None and not mine["ok"]:
                raise RuntimeError(f"REFT-Ckpt persist failed: "
                                   f"{'; '.join(mine['errors'])}")
        return s

    # ---------------------------------------------------------- restore
    def _ladder_extra(self) -> dict:
        """Tier-4 hook: extra `reft_recovery_ladder` kwargs (the object
        store the checkpoint tier falls through to).  Empty here;
        `ObjStoreCheckpointer` overrides it."""
        return {}

    def _restore_sched(self):
        """Build the read-scheduler config for this restore.

        Mode and the token-bucket cap come from the spec options (via
        `ReftConfig`); EWMA bandwidth priors come from the attached
        `FailureObserver`'s per-source history when a session wired one
        in, so a source that dragged the last restore starts this one
        already marked slow.  Returns None for mode "fcfs" so the legacy
        executor runs untouched.
        """
        from repro_torch.core.readsched import SchedConfig
        rcfg = self.group.cfg
        if rcfg.restore_sched == "fcfs" and rcfg.restore_bw_limit <= 0:
            return None
        priors = {}
        obs = getattr(self, "observer", None)
        if obs is not None:
            priors = dict(getattr(obs, "source_bw", {}) or {})
        return SchedConfig(mode=rcfg.restore_sched,
                           restore_bw_limit=rcfg.restore_bw_limit,
                           priors=priors)

    def restore(self, step=None, target=None):
        from repro_torch.core.coordinator import NodeState
        if target is None:
            target = RestoreTarget(sg_size=self.spec.sg_size)
        t0 = time.perf_counter()
        # drain each member best-effort: one dying member's flight error
        # (e.g. its SMP was killed mid-send) must never abort recovery —
        # mark it degraded so the ladder excludes it and RAIM5 repairs it
        for e in self.group.engines:
            if self.group.states[e.node] != NodeState.HEALTHY:
                continue
            try:
                e.wait()
            except Exception:
                e.degraded = True
        # a degraded member's SMP is gone: its segments (if any survive)
        # hold STALE steps that would drag the common step backwards —
        # treat it like a failed node and let RAIM5 repair it instead
        alive = [i for i in range(self.group.n)
                 if self.group.states[i] != NodeState.OFFLINE
                 and not self.group.engines[i].degraded]
        # a member whose trainer failed (its SMP lives on) is not drained:
        # its newest flight may still be in the air, and then the ladder
        # decodes it from parity. Record what the ladder read and what
        # each engine had seen land before that read began.
        info: dict = {}
        began = time.monotonic()
        res = reft_recovery_ladder(
            self.group.run, self.group.n, self.group.total_bytes,
            self.group.template, alive, self.spec.ckpt_dir,
            step=step, target=target, sched=self._restore_sched(),
            info=info, **self._ladder_extra())
        res = dataclasses.replace(
            res, clean=info.get("clean"),
            flights={i: self.group.engines[i].flights_at(began)
                     for i in alive})
        ld = res.load
        self.emit("restore", res.step, seconds=time.perf_counter() - t0,
                  tier=res.tier, nbytes=ld.bytes_read if ld else 0,
                  detail=(f"read={ld.bytes_read} decoded={ld.decoded_bytes}"
                          f"{' resharded' if ld.resharded else ''}"
                          if ld else ""))
        return res

    # ----------------------------------------------------------- health
    def _check_degraded(self, step):
        for e in self.group.engines:
            if e.degraded and e.node not in self._degraded_emitted:
                self._degraded_emitted.add(e.node)
                self.emit("degraded", step, detail=f"node{e.node}:smp-lost")

    def _tick_preempts(self):
        """Fire pending spot reclaims whose grace window has expired: the
        node is gone exactly as if it had hard-failed (SMP killed, shm
        unlinked, OFFLINE)."""
        if not self._preempts:
            return
        now = time.monotonic()
        for node, deadline in list(self._preempts.items()):
            if now >= deadline:
                del self._preempts[node]
                self._preempted.append(node)
                self.group.inject_node_failure(node)
                self.emit("preempted", -1, detail=f"node{node}")

    def health(self):
        from repro_torch.core.coordinator import NodeState
        self._tick_preempts()
        now = time.monotonic()
        members = {}
        degraded = []
        for e in self.group.engines:
            st = self.group.states[e.node]
            smp_alive = e.smp.alive()
            # a dead SMP is degradation even before a send notices it
            # (killed between snapshots: `e.degraded` has not flipped yet)
            bad = e.degraded or st != NodeState.HEALTHY or not smp_alive
            members[e.node] = {
                "state": st.value,
                "degraded": e.degraded,
                "smp_alive": smp_alive,
                "last_clean_step": e.last_clean_step,
            }
            if bad:
                degraded.append(e.node)
        return {"healthy": not degraded, "degraded": degraded,
                "members": members,
                "preempting": {n: max(d - now, 0.0)
                               for n, d in self._preempts.items()},
                "preempted": list(self._preempted)}

    def stats(self):
        out = super().stats()
        eng = [e.stats for e in self.group.engines]
        out["engine_snapshots"] = sum(s["snapshots"] for s in eng)
        out["engine_bytes_sent"] = sum(s["bytes_sent"] for s in eng)
        out["engine_seconds"] = sum(s["seconds"] for s in eng)
        out["persist_inflight"] = self.group.persist_inflight()
        out["persist_overlap_seconds"] = sum(
            s.get("persist_overlap_seconds", 0.0) for s in eng)
        out["persist_errors"] = sum(s.get("persist_errors", 0) for s in eng)
        out["persist_throttle_seconds"] = sum(
            s.get("persist_throttle_seconds", 0.0) for s in eng)
        out["persist_bw_limit"] = float(
            self.spec.options.get("persist_bw_limit", 0.0))
        out["restore_bw_limit"] = float(
            self.spec.options.get("restore_bw_limit", 0.0))
        out["restore_sched"] = self.spec.options.get(
            "restore_sched", "adaptive")
        out["skipped_buckets"] = sum(s.get("skipped_buckets", 0)
                                     for s in eng)
        out["delta_flights"] = sum(s.get("delta_flights", 0) for s in eng)
        out["keyframe_flights"] = sum(s.get("keyframe_flights", 0)
                                      for s in eng)
        out["delta_base_misses"] = sum(s.get("delta_base_misses", 0)
                                       for s in eng)
        up_bytes = sum(s.get("persist_upload_bytes", 0) for s in eng)
        if up_bytes:
            out["persist_upload_bytes"] = up_bytes
            out["persist_upload_seconds"] = sum(
                s.get("persist_upload_seconds", 0.0) for s in eng)
            out["persist_upload_retries"] = sum(
                s.get("persist_upload_retries", 0) for s in eng)
        for k, v in self.group.level_seconds().items():
            out[f"engine_{k}_seconds"] = v
        return out

    # ----------------------------------------------------------- faults
    def inject_failure(self, node=0, kind="software", **params):
        """Knock out a real member.  Beyond the classic `software`/`node`
        kinds, the supervisor's scenario taxonomy is supported:

          smp             kill only the fault-tolerance sidecar process
                          (segments survive; the engine degrades on its
                          next send, or `health()` notices sooner)
          laggard         SIGSTOP the member's SMP for `lag_s` seconds
                          (delayed acks / credit stalls), auto-SIGCONT
          corrupt-stripe  flip `nbytes` bytes inside the member's newest
                          CLEAN shm snapshot buffer (`seed` deterministic)
          slow-persist    raise the member's durable-tier write latency
                          to `delay_s` per shard, effective immediately
          preempt         spot reclaim notice: after `grace_s` seconds the
                          node hard-fails (health()/poll ticks fire it)
        """
        e = self.group.engines[node]
        if kind == "software":
            self.group.inject_software_failure(node)
        elif kind == "node":
            self.group.inject_node_failure(node)
        elif kind == "smp":
            e.smp.kill()
        elif kind == "laggard":
            import os
            import signal
            import threading
            lag = float(params.get("lag_s", 0.4))
            pid = e.smp.proc.pid
            try:
                os.kill(pid, signal.SIGSTOP)
            except (ProcessLookupError, PermissionError):
                pass                      # already gone: nothing to stall
            else:
                def _cont():
                    try:
                        os.kill(pid, signal.SIGCONT)
                    except (ProcessLookupError, PermissionError):
                        pass
                # a real timer thread: the trainer may be *blocked* on this
                # SMP's ring credits, so a poll-based resume would deadlock
                t = threading.Timer(lag, _cont)
                t.daemon = True
                t.start()
        elif kind == "corrupt-stripe":
            from repro_torch.supervise.inject import corrupt_shm_stripe
            kw = dict(seed=int(params.get("seed", 0)),
                      nbytes=int(params.get("nbytes", 16)),
                      step=params.get("step"),
                      region=params.get("region", "own"))
            try:
                info = corrupt_shm_stripe(
                    self.group.run, node, self.group.n,
                    self.group.total_bytes, **kw)
            except RuntimeError:
                # no CLEAN buffer yet (all flights in the air): land one,
                # then corrupt it
                e.wait()
                info = corrupt_shm_stripe(
                    self.group.run, node, self.group.n,
                    self.group.total_bytes, **kw)
            self.emit("corrupt", info["step"],
                      detail=f"node{node}:off{info['offset']}"
                             f"+{info['nbytes']}")
        elif kind == "slow-persist":
            e.persist_delay_s = float(params.get("delay_s", 0.25))
        elif kind == "preempt":
            grace = float(params.get("grace_s", 0.3))
            self._preempts[node] = time.monotonic() + grace
        else:
            raise ValueError(f"unknown failure kind {kind!r}")
        self.emit("inject", -1, detail=f"{kind}:node{node}")

    def evict(self, node):
        """Remediate a member whose live stripe is known-corrupt: take it
        OFFLINE so the next restore RAIM5-decodes it from the survivors'
        parity instead of trusting its segments."""
        self.group.inject_node_failure(node)
        self.emit("evict", -1, detail=f"node{node}")

    def heal(self):
        for i in range(self.group.n):
            self.group.heal(i)
        self._degraded_emitted.clear()        # healed members report anew
        self._preempted.clear()
        self.emit("heal", -1)

    def wait(self):
        self.group.wait()
        self._emit_rounds(self.group.drain_persists())

    def close(self):
        try:                              # join outstanding persists so a
            self._emit_rounds(            # durable family is never torn
                self.group.drain_persists(30))   # by a clean shutdown
        except Exception:
            pass
        self.group.close()


@register_backend("reft")
def _make_reft(spec: CheckpointSpec, template: Any) -> Checkpointer:
    return ReftCheckpointer(spec, template)


class NullCheckpointer(Checkpointer):
    """No fault tolerance at all — the paper's 'no checkpointing' baseline
    and the overhead floor every other backend is measured against."""

    name = "null"

    def __init__(self, spec: CheckpointSpec, state_template: Any):
        super().__init__(spec)

    def snapshot(self, state, step, extra_meta=None, wait=False):
        return True

    def persist(self, step=None, wait=True):
        return None

    def restore(self, step=None, target=None):
        raise RecoveryError("null backend keeps nothing to restore")

    def health(self):
        return {"healthy": True, "degraded": [], "members": {}}

    def close(self):
        pass


@register_backend("null")
def _make_null(spec: CheckpointSpec, template: Any) -> Checkpointer:
    return NullCheckpointer(spec, template)
