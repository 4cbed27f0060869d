"""Sharded & parallel asynchronous snapshotting (paper §4.1).

Each SG member snapshots (a) its own 1/n byte-shard of the train state and
(b) the blocks of its parity stripe (XOR-folded in the SMP), in tiny
buckets, asynchronously with training.

Snapshot consistency (PyTorch port): the port's train step is out of place
(`repro_torch.train.steps`: no in-place update of any state leaf, no
`torch.optim`), so holding references to the step-t leaves pins a
consistent snapshot, as JAX's immutable arrays do in the reference — no
device-side copy of the state before the async d2h copy.  The flight reads
the leaves on a side stream after an event the trainer's stream recorded
(`repro_torch.core.pipeline.DeviceFence`).

`SnapshotEngine` is a thin facade: the saving hot path is the hierarchical
async pipeline in `repro_torch.core.pipeline` (L1 device pump / L2 host stager /
L3 event-driven SMP — HASC).  ``ReftConfig(pipeline=False)`` keeps the
pre-refactor single serial thread (read -> CRC -> blocking ring send per
bucket) as a measurable baseline for the pipeline's interference win.
"""
from __future__ import annotations

import pickle
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import raim5
from repro_torch.core.delta import DeltaLog, DeltaTracker
from repro_torch.core.pipeline import (DeltaBaseMismatch, LeafReader,
                                 PipelineFlight, SnapshotPipeline,
                                 leaf_budget, resolve_affinity,
                                 resolve_device_encode)
from repro_torch.core.smp import NodeLayout, SMPHandle
from repro_torch.core.treebytes import FlatSpec, leaf_arrays, make_flat_spec

# Back-compat alias: the reader grew eviction budgets and moved into the
# pipeline module where both the pipelined and serial paths share it.
_LeafReader = LeafReader


def _trace_default() -> bool:
    import os
    return os.environ.get("REPRO_TRACE_PROTOCOL", "") not in ("", "0")


@dataclass(frozen=True)
class ReftConfig:
    bucket_bytes: int = 4 << 20
    stage_slots: int = 8
    snapshot_every_steps: int = 1
    checkpoint_every_snapshots: int = 50       # REFT-Ckpt tier
    ckpt_dir: str = "/tmp/reft-ckpt"
    run_id: str = field(default_factory=lambda: uuid.uuid4().hex[:8])
    # --- HASC pipeline knobs (repro_torch.core.pipeline) ---
    pipeline: bool = True            # False = pre-refactor serial thread
    prefetch_window: int = 4         # buckets of copy_to_host_async ahead
    scratch_buffers: int = 2         # double-buffered L1 scratch fills
    opt_first: bool = True           # drain optimizer-moment leaves first
    yield_every_buckets: int = 4     # L1 yields to training this often
    boundary_timeout_s: float = 0.005  # max wait for a step boundary
    # --- device-side encode + multi-flight (docs/API.md) ---
    device_encode: str = "auto"      # "auto" (on iff the state lives on
                                     # the card) | "on" | "off"
    max_flights: int = 1             # >1: snapshot N+1's L1 may overlap
                                     # snapshot N's L2/L3 drain
    pin_cpus: Any = "auto"           # saving-path CPU set for the L2
                                     # stager + SMP: "auto" | "off" | ids
    # --- async REFT-Ckpt persistence (docs/API.md "Async persistence") ---
    persist_delay_s: float = 0.0     # simulated durable-tier latency per
                                     # persist (tests / interference bench)
    persist_bw_limit: float = 0.0    # token-bucket cap (bytes/s) on the
                                     # SMP's background persist + upload
                                     # writes; 0 = unlimited
    # --- dirty-delta snapshots (docs/API.md "Delta snapshots") ---
    delta: bool = False              # delta flights between full keyframes
                                     # (requires pipeline=True, max_flights=1)
    delta_keyframe: int = 8          # force a full keyframe every N flights
    delta_dirty_threshold: float = 0.6   # dirty fraction above which a
                                     # delta saves nothing -> keyframe
    delta_digest: bool = True        # per-bucket CRC compare vs the base
                                     # (off: provider ranges only)
    ranged_fetch: str = "auto"       # sparse delta flights d2h only the
                                     # touched leaf extents: "auto" (on iff
                                     # a real accelerator) | "on" | "off"
    # --- straggler-aware loading (docs/API.md "Straggler-aware loading") ---
    restore_sched: str = "adaptive"  # restore read executor: "fcfs"
                                     # (legacy one-thread-per-member) |
                                     # "steal" (chunked work-stealing) |
                                     # "adaptive" (+ parity reroute/hedges)
    restore_bw_limit: float = 0.0    # token-bucket cap (bytes/s) on all
                                     # restore reads; 0 = unlimited
                                     # (read-side twin of persist_bw_limit)
    # runtime SMP protocol validation (repro_torch.analyze.protocol): every
    # pipe message is checked against the flight FSM; desyncs raise
    # ProtocolViolation instead of wedging a blocking recv.  Defaults to
    # the REPRO_TRACE_PROTOCOL env var so CI can turn it on fleet-wide.
    trace_protocol: bool = field(default_factory=lambda: _trace_default())


@dataclass
class FlightRecord:
    """A launched flight as its engine saw it: the step, and the monotonic
    time at which its SMP acknowledged the step clean (None until then,
    and for a flight that failed)."""
    step: int
    landed_at: Optional[float] = None


class SnapshotEngine:
    """REFT-Sn for one node of an SG of n members (facade over the HASC
    pipeline; one snapshot in flight at a time)."""

    def __init__(self, node: int, n: int, state_template: Any,
                 cfg: Optional[ReftConfig] = None, run_id: str = None):
        # NB: a `cfg=ReftConfig()` default would be evaluated once at import,
        # so every default-constructed engine would share one run_id (one
        # shm namespace) — construct a fresh config per instance instead.
        cfg = cfg if cfg is not None else ReftConfig()
        self.node, self.n, self.cfg = node, n, cfg
        self.run = run_id or cfg.run_id
        self.spec = make_flat_spec(state_template)
        self.layout = NodeLayout(n, self.spec.total_bytes)
        affinity = resolve_affinity(getattr(cfg, "pin_cpus", None))
        self.smp = SMPHandle(self.run, node, n, self.spec.total_bytes,
                             stage_slots=cfg.stage_slots,
                             bucket_bytes=cfg.bucket_bytes,
                             pin_cpus=affinity,
                             trace=cfg.trace_protocol)
        self._own = self._own_plan()
        self._stripe = self._stripe_plan()
        self._pipeline: Optional[SnapshotPipeline] = None
        if cfg.pipeline:
            self._pipeline = SnapshotPipeline(
                self.smp, self.spec, cfg, self._own, self._stripe,
                leaves=leaf_arrays(state_template))
        self._max_flights = max(1, int(getattr(cfg, "max_flights", 1))) \
            if cfg.pipeline else 1
        # dirty-delta snapshotting: only meaningful on the pipelined path
        # with a single flight in the air (a delta's base must be the
        # SMP's latest clean step, which overlap would race)
        self._tracker: Optional[DeltaTracker] = None
        self._delta_log: Optional[DeltaLog] = None
        self._dirty_provider = None
        if getattr(cfg, "delta", False) and cfg.pipeline \
                and self._max_flights == 1:
            self._tracker = DeltaTracker(
                keyframe_every=max(1, int(getattr(cfg, "delta_keyframe",
                                                  8))),
                dirty_threshold=float(getattr(cfg, "delta_dirty_threshold",
                                              0.6)),
                digest=bool(getattr(cfg, "delta_digest", True)))
            self._delta_log = DeltaLog()
        self._flight_bytes = sum(t.hi - t.lo
                                 for t in self._pipeline.schedule) \
            if self._pipeline is not None else self.spec.total_bytes
        self._flights: List[PipelineFlight] = []
        self._thread: Optional[threading.Thread] = None    # serial mode
        self._err: Optional[BaseException] = None
        self.degraded = False      # SMP unreachable: snapshots paused, not fatal
        # mutable copy of cfg.persist_delay_s: ReftConfig is frozen, but
        # fault injection (slow-persist / slow-NFS scenarios) must be able
        # to raise durable-tier latency mid-run
        self.persist_delay_s = float(getattr(cfg, "persist_delay_s", 0.0))
        self.last_clean_step = -1
        # the newest launched flights, oldest first, as this engine saw
        # them (`flights_at`)
        self.flights: Deque[FlightRecord] = deque(maxlen=8)
        self._persists: Dict[int, dict] = {}    # seq -> in-flight record
        self.stats = {"snapshots": 0, "bytes_sent": 0, "seconds": 0.0,
                      "l1_seconds": 0.0, "l1_stall_seconds": 0.0,
                      "l2_seconds": 0.0, "l3_seconds": 0.0,
                      "overlapped_flights": 0,
                      "persists": 0, "persist_inflight": 0,
                      "persist_seconds": 0.0,
                      "persist_overlap_seconds": 0.0,
                      "persist_errors": 0,
                      "persist_throttle_seconds": 0.0,
                      "persist_upload_seconds": 0.0,
                      "persist_upload_bytes": 0,
                      "persist_upload_retries": 0,
                      "device_encode": (self._pipeline.device_encode
                                        if self._pipeline else False),
                      "stager_affinity": None,
                      "skipped_buckets": 0, "delta_flights": 0,
                      "keyframe_flights": 0, "delta_base_misses": 0,
                      # of skipped_buckets, those the dirty provider
                      # ruled clean (never read), counted at launch
                      "provider_clean_buckets": 0}

    @property
    def _flight(self) -> Optional[PipelineFlight]:
        """Newest owned flight (back-compat accessor; multi-flight engines
        own a queue)."""
        return self._flights[-1] if self._flights else None

    # ------------------------------------------------------------- plan
    def _own_plan(self) -> List[Tuple[int, int, int]]:
        """[(dst_offset_in_own_region, lo, hi)] global byte ranges."""
        lay = self.layout
        if self.n == 1:
            return [(0, 0, self.spec.total_bytes)]
        out = []
        for li, ref in enumerate(raim5.data_blocks_of_node(self.node, self.n)):
            lo, hi = ref.byte_range(lay.bs, self.n)
            out.append((li * lay.bs, lo, hi))
        return out

    def _stripe_plan(self) -> List[Tuple[int, int]]:
        if self.n == 1:
            return []
        lay = self.layout
        return [ref.byte_range(lay.bs, self.n)
                for ref in raim5.parity_stripe_of_node(self.node, self.n)]

    # -------------------------------------------------------- snapshot
    def in_flight(self) -> bool:
        if any(f.in_flight() for f in self._flights):
            return True
        return self._thread is not None and self._thread.is_alive()

    def snapshot_async(self, state: Any, step: int,
                       extra_meta: dict = None) -> bool:
        """Fire-and-forget; returns False when no flight slot is free
        (frequency self-limits to the achievable rate, Figure 4).  With
        `max_flights > 1` a new flight may launch while its predecessor
        is still draining L2/L3 (multi-flight overlap)."""
        if self.degraded:
            return False
        if self._thread is not None and self._thread.is_alive():
            return False                       # serial mode: single flight
        self._collect_finished()
        self._raise_pending()
        if self.degraded:                  # the drain just found a dead SMP
            return False
        if len(self._flights) >= self._max_flights:
            return False
        leaves = leaf_arrays(state)                    # pin the references
        if self._pipeline is not None:
            overlapped = any(f.in_flight() for f in self._flights)
            plan = None
            if self._tracker is not None:
                ranges = None
                if self._dirty_provider is not None:
                    ranges = self._dirty_provider()
                plan = self._tracker.plan(self.last_clean_step,
                                          self._pipeline.schedule, ranges,
                                          self.spec.total_bytes)
                if plan is not None:
                    self.stats["provider_clean_buckets"] += len(plan.skip)
            rec = FlightRecord(int(step))
            self._flights.append(self._pipeline.start(leaves, int(step),
                                                      extra_meta or {},
                                                      delta=plan,
                                                      record=rec))
            self.flights.append(rec)
            if overlapped:
                self.stats["overlapped_flights"] += 1
            return True
        rec = FlightRecord(int(step))
        self._thread = threading.Thread(
            target=self._run_serial, args=(leaves, int(step),
                                           extra_meta or {}, rec),
            daemon=True, name=f"snap-n{self.node}")
        self.flights.append(rec)
        self._thread.start()
        return True

    def flights_at(self, t: float) -> Dict[str, List[int]]:
        """The newest launched flights as this engine saw them at
        monotonic time `t`: {"landed": steps whose SMP had acknowledged
        them clean by then, "in_air": steps launched and not acknowledged
        (still in flight, or failed)}."""
        out: Dict[str, List[int]] = {"landed": [], "in_air": []}
        for rec in list(self.flights):
            landed = rec.landed_at is not None and rec.landed_at <= t
            out["landed" if landed else "in_air"].append(rec.step)
        return out

    def set_dirty_provider(self, fn) -> None:
        """Install the delta saving path's dirtiness signal: a callable
        returning the merged GLOBAL byte ranges that may have changed
        since the previous flight (or None for "unknown — digest-compare
        everything").  E.g. `repro_torch.core.delta.expert_dirty_ranges` over
        the MoE router's `TOUCHED.consume()` mask.  Consumed once per
        launched flight; no-op for non-delta engines."""
        self._dirty_provider = fn

    def snapshot_sync(self, state: Any, step: int,
                      extra_meta: dict = None) -> int:
        if not self.snapshot_async(state, step, extra_meta):
            return self.last_clean_step        # degraded: keep training
        return self.wait()

    def wait(self, timeout: float = 300.0) -> int:
        """Drain every in-flight snapshot (oldest first).  On timeout the
        live flight handles are KEPT (a snapshot can never be dropped
        while live) and a `TimeoutError` is raised instead."""
        deadline = time.monotonic() + timeout
        while self._flights:
            left = max(0.0, deadline - time.monotonic())
            self._collect_flight(left)         # raises TimeoutError if live
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"serial snapshot thread still running after "
                    f"{timeout:.1f}s; still in flight")
            self._thread = None
        self._raise_pending()
        return self.last_clean_step

    def _collect_finished(self):
        """Fold every already-finished flight (oldest first) into stats
        without blocking on the live ones."""
        while self._flights and self._flights[0].done.is_set():
            self._collect_flight(0.0)

    def _collect_flight(self, timeout: float):
        """Fold the OLDEST flight into stats.  A TimeoutError from a flight
        that is genuinely still LIVE propagates (the flight stays owned);
        a flight that FAILED with an internal TimeoutError (e.g. the SMP
        ack timed out) is a dead flight and is routed through _err so the
        engine degrades exactly like the serial path."""
        if not self._flights:
            return
        flight = self._flights[0]
        try:
            res = flight.wait(timeout)
        except TimeoutError:
            if flight.in_flight():
                raise                          # flight stays current
            try:                               # finished during the wait:
                res = flight.wait(0.0)         # collect its real outcome
            except BaseException as e:
                self._flights.pop(0)
                self._flight_failed(e)
                return                         # surfaced by _raise_pending
        except BaseException as e:
            self._flights.pop(0)
            self._flight_failed(e)
            return                             # surfaced by _raise_pending
        self._flights.pop(0)
        self.last_clean_step = res.clean_step
        st = self.stats
        st["snapshots"] += 1
        st["bytes_sent"] += res.bytes_sent
        st["seconds"] += res.wall_seconds
        st["l1_seconds"] += res.l1_seconds
        st["l1_stall_seconds"] += res.l1_stall_seconds
        st["l2_seconds"] += res.l2_seconds
        st["l3_seconds"] += res.l3_seconds
        if self._pipeline is not None:
            st["stager_affinity"] = self._pipeline.applied_affinity
        if self._tracker is not None:
            was_delta = res.delta_base is not None
            frac = (res.bytes_sent / self._flight_bytes
                    if self._flight_bytes else 1.0)
            self._tracker.commit(res.clean_step, res.digests, was_delta,
                                 frac)
            self._delta_log.record(res.clean_step,
                                   res.sent_extents if was_delta else None)
            st["skipped_buckets"] += res.skipped_buckets
            st["delta_flights" if was_delta else "keyframe_flights"] += 1

    def _flight_failed(self, e: BaseException) -> None:
        """A flight died without publishing: remember the error AND drop
        the delta base — provider dirty ranges consumed by the dead
        flight are lost, so the next flight must be a full keyframe."""
        if self._tracker is not None:
            self._tracker.invalidate()
        if self._err is None:
            self._err = e

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            if isinstance(err, DeltaBaseMismatch):
                # the SMP's clean buffer rotated away from the planned
                # base (e.g. under persist-pin pressure): the flight
                # aborted cleanly, nothing was published, and the tracker
                # was already invalidated — next flight keyframes.  Not a
                # fault: training and snapshotting both continue.
                if self._tracker is not None:
                    self._tracker.base_misses += 1
                self.stats["delta_base_misses"] += 1
                return
            if isinstance(err, (BrokenPipeError, EOFError, ConnectionError,
                                TimeoutError, OSError)):
                # SMP process is gone: the paper's stance is that training
                # must not die with its fault-tolerance sidecar — degrade.
                self.degraded = True
                return
            raise err

    # ------------------------------------------------- serial baseline
    def _run_serial(self, leaves, step, extra_meta, rec):
        """Pre-refactor monolithic path (read -> CRC -> blocking ring send
        per bucket), kept as the interference baseline the HASC pipeline
        is measured against (`ReftConfig(pipeline=False)`)."""
        try:
            import zlib
            t0 = time.time()
            budget = leaf_budget(
                self.spec, [(lo, hi) for _, lo, hi in self._own]
                + list(self._stripe))
            reader = LeafReader(self.spec, leaves, budget)
            bb = self.cfg.bucket_bytes
            scratch = np.empty(bb, np.uint8)
            sent = 0
            crc = 0
            l1 = l2 = l3 = 0.0
            t = time.perf_counter()
            self.smp.begin(step)
            l3 += time.perf_counter() - t
            for dst0, lo, hi in self._own:
                for a in range(lo, hi, bb):
                    b = min(a + bb, hi)
                    t = time.perf_counter()
                    reader.read(a, b, scratch[:b - a])
                    crc = zlib.crc32(scratch[:b - a], crc)
                    l1 += time.perf_counter() - t
                    t = time.perf_counter()
                    self.smp.send_bucket(0, dst0 + (a - lo), scratch[:b - a])
                    l2 += time.perf_counter() - t
                    sent += b - a
            for lo, hi in self._stripe:
                for a in range(lo, hi, bb):
                    b = min(a + bb, hi)
                    t = time.perf_counter()
                    reader.read(a, b, scratch[:b - a])
                    l1 += time.perf_counter() - t
                    t = time.perf_counter()
                    self.smp.send_bucket(1, a - lo, scratch[:b - a])
                    l2 += time.perf_counter() - t
                    sent += b - a
            meta = {"spec": self.spec.to_json(), "step": step,
                    "extra": extra_meta, "crc_own": crc}
            t = time.perf_counter()
            self.smp.end(step, pickle.dumps(meta))
            self.last_clean_step = self.smp.wait_clean()
            rec.landed_at = time.monotonic()
            l3 += time.perf_counter() - t
            self.stats["snapshots"] += 1
            self.stats["bytes_sent"] += sent
            self.stats["seconds"] += time.time() - t0
            self.stats["l1_seconds"] += l1
            self.stats["l2_seconds"] += l2
            self.stats["l3_seconds"] += l3
        except BaseException as e:                      # surfaced on wait()
            self._err = e

    # ------------------------------------------------------------ ckpt
    def delta_extents_since(self, base: Optional[int],
                            step: int) -> Optional[List[Tuple[int, int]]]:
        """Buffer-local extents a `.reftd` persisted at `step` must carry
        relative to a base persisted at `base`, or None when no valid
        chain exists (keyframe in the span, unknown base, delta off) and
        the persist must be a full `.reft`."""
        if self._delta_log is None or base is None:
            return None
        return self._delta_log.extents_since(int(base), int(step))

    def persist_async(self, path: str, step: Optional[int] = None,
                      remote: Optional[dict] = None,
                      delta_base: Optional[int] = None) -> int:
        """REFT-Ckpt, overlapped: fire the persist and return a ticket
        (the SMP streams the pinned shard to disk on its own background
        thread while snapshots keep flowing).  Collect with
        `poll_persists` / `persist_join` / `persist_wait_all`.
        `remote` ({store, key, retry}) asks the SMP worker to mirror the
        shard to an object store — tier 4 — after the local write.
        `delta_base` (with an explicit `step`) asks for a `.reftd` delta
        shard carrying only the extents rewritten since that base — the
        caller must have verified the chain via `delta_extents_since`."""
        opts = {}
        bw = float(getattr(self.cfg, "persist_bw_limit", 0.0) or 0.0)
        if bw > 0:
            opts["bw_limit"] = bw
        if remote:
            opts["remote"] = remote
        if delta_base is not None and step is not None:
            ext = self.delta_extents_since(delta_base, step)
            if ext is None:
                raise ValueError(
                    f"no delta chain from step {delta_base} to {step}")
            opts["delta"] = {"base_step": int(delta_base),
                             "extents": [(int(a), int(b)) for a, b in ext]}
        seq = self.smp.persist_send(
            path, step, delay_s=self.persist_delay_s,
            opts=opts or None)
        self._persists[seq] = {"path": path, "step": step,
                               "t0": time.monotonic(), "blocked": 0.0}
        self.stats["persist_inflight"] = len(self._persists)
        return seq

    def _finish_persist(self, seq: int, msg) -> dict:
        rec = self._persists.pop(seq)
        dt = time.monotonic() - rec["t0"]
        st = self.stats
        st["persist_inflight"] = len(self._persists)
        st["persists"] += 1
        st["persist_seconds"] += dt
        # the share of the persist's lifetime nobody spent blocked on it
        # — the paper's "durable tier off the training path" in seconds
        st["persist_overlap_seconds"] += max(0.0, dt - rec["blocked"])
        out = {"seq": seq, "path": rec["path"], "step": rec["step"],
               "seconds": dt, "error": None}
        if msg[0] == "persist-error":
            st["persist_errors"] += 1
            out["error"] = msg[2]
        else:
            out["path"], out["step"] = msg[2], msg[3]
            info = msg[4] if len(msg) > 4 and isinstance(msg[4], dict) \
                else {}
            st["persist_throttle_seconds"] += info.get("throttle_s", 0.0)
            up = info.get("upload")
            if up:
                st["persist_upload_seconds"] += up.get("upload_s", 0.0)
                st["persist_upload_bytes"] += up.get("upload_bytes", 0)
                st["persist_upload_retries"] += up.get("retries", 0)
                out["upload"] = up
        return out

    def _lost_persist(self, seq: int, why: str) -> dict:
        """SMP died under an in-flight persist: degrade (snapshots pause,
        training continues) and surface the loss as an error record."""
        self.degraded = True
        rec = self._persists.pop(seq)
        self.stats["persist_inflight"] = len(self._persists)
        self.stats["persist_errors"] += 1
        return {"seq": seq, "path": rec["path"], "step": rec["step"],
                "seconds": time.monotonic() - rec["t0"], "error": why}

    def has_persist_ticket(self, seq: int) -> bool:
        """True while ticket `seq` is outstanding (fired, not yet
        collected by poll/join) — the group's drain liveness check."""
        return seq in self._persists

    def poll_persists(self) -> List[dict]:
        """Non-blocking: completion records of every finished persist
        ({seq, path, step, seconds, error})."""
        done = []
        for seq in sorted(self._persists):
            try:
                msg = self.smp.persist_poll(seq)
            except (EOFError, BrokenPipeError, ConnectionError, OSError):
                done.append(self._lost_persist(seq, "SMP lost mid-persist"))
                continue
            if msg is not None:
                done.append(self._finish_persist(seq, msg))
        return done

    def persist_join(self, seq: int, timeout: float = 120.0) -> dict:
        """Block until ticket `seq` completes; returns its record (an
        `error` entry instead of raising — callers decide policy)."""
        rec = self._persists[seq]
        t0 = time.monotonic()
        try:
            msg = self.smp.persist_result(seq, timeout)
        except TimeoutError:
            rec["blocked"] += time.monotonic() - t0
            # the handle marked the seq stale (its late reply will be
            # discarded), so this ticket can never complete: drop it
            self._persists.pop(seq, None)
            self.stats["persist_inflight"] = len(self._persists)
            self.stats["persist_errors"] += 1
            raise
        except (EOFError, BrokenPipeError, ConnectionError, OSError):
            return self._lost_persist(seq, "SMP lost mid-persist")
        rec["blocked"] += time.monotonic() - t0
        return self._finish_persist(seq, msg)

    def persist_wait_all(self, timeout: float = 120.0) -> List[dict]:
        """Join every outstanding persist (oldest first)."""
        deadline = time.monotonic() + timeout
        out = []
        for seq in sorted(self._persists):
            out.append(self.persist_join(
                seq, max(0.01, deadline - time.monotonic())))
        return out

    def persist(self, path: str, step: Optional[int] = None,
                timeout: float = 120.0) -> str:
        """REFT-Ckpt, blocking: SMP writes its clean shard+parity to disk
        without touching the training process (a specific clean step if
        given); raises on persist failure."""
        rec = self.persist_join(self.persist_async(path, step), timeout)
        if rec["error"]:
            raise RuntimeError(f"SMP persist failed: {rec['error']}")
        return rec["path"]

    def close(self):
        try:
            if self.in_flight():
                self.wait(timeout=30)
        except Exception:
            pass
        try:
            if self._persists:            # never strand a durable write
                self.persist_wait_all(timeout=30)
        except Exception:
            pass
        self.smp.stop()
