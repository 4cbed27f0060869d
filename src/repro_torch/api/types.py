"""Unified checkpointing facade: protocol types.

One `Checkpointer` interface in front of every save/restore engine in the
repo — REFT's in-memory three-tier ladder and the disk baselines — so the
paper's headline comparison (near-zero in-memory overhead vs disk
checkpointing) is a one-flag swap in every trainer, benchmark, and example.

A backend implements:
  snapshot(state, step)  cheap/frequent tier (in-memory for REFT, the disk
                         write itself for disk backends)
  persist(step)          durable tier (REFT-Ckpt shard persist; fsync/drain
                         for disk backends)
  restore(step)          best state the backend can reconstruct, with the
                         recovery tier that produced it
  health()               structured liveness/degradation report
  close()                release processes / shared memory / threads

and emits `CkptEvent` records for every operation, so callers get uniform
stats without reaching into backend internals.
"""
from __future__ import annotations

import abc
import time
import uuid
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Optional


@dataclass(frozen=True)
class CkptEvent:
    """One structured record per checkpointing operation."""
    kind: str                     # snapshot | persist | persist-error |
                                  # restore | degraded | inject | heal | gc
    step: int
    backend: str
    seconds: float = 0.0
    nbytes: int = 0
    tier: Optional[str] = None    # restore only: in-memory | raim5 | ...
    detail: str = ""
    # saving-pipeline decomposition for this operation (seconds spent per
    # HASC level: l1 device reads / l1_stall credit waits / l2 ring writes
    # / l3 SMP signaling+ack); None for backends without a pipeline
    levels: Optional[Dict[str, float]] = None
    wall: float = field(default_factory=time.time)


@dataclass(frozen=True)
class RestoreTarget:
    """Where a restore is going — the reshard-on-restore contract.

    The snapshot may have been taken by an n-member SG on one mesh; the
    restoring job declares its OWN layout here and the distributed loader
    (`repro_torch.core.loader`) computes the minimal old-layout byte ranges to
    read.  All filters compose by intersection; everything defaults to a
    full-state restore.
    """
    sg_size: Optional[int] = None     # restoring group's SG size (n -> m)
    member: Optional[int] = None      # only this NEW member's byte shard
    leaves: Optional[Tuple[str, ...]] = None   # leaf-path substrings
    shardings: Any = None             # PartitionSpec pytree (repro_torch.dist)
    mesh: Any = None                  # target mesh the shardings refer to
    coord: Optional[Dict[str, int]] = None     # this rank's mesh coords
    device_put: bool = False          # overlapped h2d during assembly


@dataclass(frozen=True)
class RestoreResult:
    """What `Checkpointer.restore()` hands back to the training loop."""
    state: Any
    step: int
    extra_meta: dict
    tier: str                     # which rung of the ladder produced it
    # per-phase load accounting from the distributed loader (None for
    # backends that bypass it): tier/source, bytes_read, decoded_bytes,
    # read/decode/h2d seconds, resharded flag (repro_torch.core.loader.LoadStats)
    load: Optional[Any] = None
    # backends with SMPs, when the ladder read them: each member's clean
    # steps as that read found them ({member: [steps]}), and each live
    # member's newest flights as its own engine saw them when the read
    # began ({member: {"landed": [steps], "in_air": [steps]}}, see
    # `SnapshotEngine.flights_at`). None for other backends and tiers.
    clean: Optional[dict] = None
    flights: Optional[dict] = None


@dataclass(frozen=True)
class CheckpointSpec:
    """Declarative backend selection + tuning, shared by every trainer.

    `backend` is a registry name ("reft", "sync_disk", "async_disk",
    "null", ...); everything else is cadence/layout the `CheckpointSession`
    and the backend share.  Backend-specific extras go in `options`.
    """
    backend: str = "reft"
    ckpt_dir: str = "/tmp/repro-ckpt"
    sg_size: int = 4                    # SG members (reft) / ranks (disk)
    snapshot_every_steps: int = 1
    checkpoint_every_steps: int = 50
    bucket_bytes: int = 4 << 20
    keep: int = 3                       # retention (complete ckpt families)
    run_id: Optional[str] = None        # None -> session allocates one
    resume: bool = True                 # restore-on-entry when possible
    auto_tune: bool = False             # Appendix-A cadence retuning
    lam_node: float = 1e-4
    fsync: bool = False
    options: Dict[str, Any] = field(default_factory=dict)

    def with_run_id(self, run_id: str) -> "CheckpointSpec":
        return replace(self, run_id=run_id)

    @staticmethod
    def alloc_run_id() -> str:
        return uuid.uuid4().hex[:8]

    def build(self, state_template: Any) -> "Checkpointer":
        from repro_torch.api.registry import create_checkpointer
        return create_checkpointer(self, state_template)


class Checkpointer(abc.ABC):
    """Pluggable checkpointing backend (see module docstring)."""

    name: str = "abstract"
    # whether `persist()` can fire nothing while captures exist (REFT: no
    # step clean on every member yet, the first flights still in the air);
    # the session then tries again at the next step
    persist_can_defer: bool = False
    # whether a restore's heal() leaves members holding no snapshot (REFT:
    # a respawned SMP starts empty), so that the session snapshots at the
    # next step whatever the cadence
    snapshot_after_restore: bool = False

    # events kept for inspection are bounded; stats aggregate ALL events
    # incrementally so stats() stays O(1) (auto-tune calls it every step)
    EVENT_BUFFER = 4096

    def __init__(self, spec: CheckpointSpec):
        from collections import deque
        self.spec = spec
        self.events = deque(maxlen=self.EVENT_BUFFER)
        self.on_event: Optional[Callable[[CkptEvent], None]] = None
        self._agg: Dict[str, Any] = {}

    # ------------------------------------------------------------- emit
    def emit(self, kind: str, step: int, **kw) -> CkptEvent:
        ev = CkptEvent(kind=kind, step=int(step), backend=self.name, **kw)
        self.events.append(ev)
        agg = self._agg
        agg[kind] = agg.get(kind, 0) + 1
        agg[f"{kind}_seconds"] = agg.get(f"{kind}_seconds", 0.0) + ev.seconds
        agg[f"{kind}_bytes"] = agg.get(f"{kind}_bytes", 0) + ev.nbytes
        if self.on_event is not None:
            self.on_event(ev)
        return ev

    def stats(self) -> dict:
        """Aggregate event counters (uniform across backends)."""
        return {"backend": self.name, **self._agg}

    # --------------------------------------------------------- protocol
    @abc.abstractmethod
    def snapshot(self, state: Any, step: int, extra_meta: dict = None,
                 wait: bool = False) -> bool:
        """Capture `state` at `step`; False if skipped (in-flight save,
        degraded backend).  `wait=True` blocks until the capture is clean."""

    @abc.abstractmethod
    def persist(self, step: Optional[int] = None,
                wait: bool = True) -> Optional[int]:
        """Make the newest clean capture durable; returns its step (None
        when there is nothing to persist).  `wait=False` fires the
        durable write WITHOUT blocking on disk I/O and returns the step
        as a ticket — completion is collected by `poll_persists()` /
        `wait()` and surfaced as `persist` events; backends whose persist
        is inherently synchronous may ignore the flag."""

    @abc.abstractmethod
    def restore(self, step: Optional[int] = None,
                target: Optional[RestoreTarget] = None) -> RestoreResult:
        """Reconstruct state (newest available, or exactly `step`).
        `target` declares the restoring job's layout (reshard-on-restore,
        partial loads); backends without a distributed loader may ignore
        it.  Raises `repro_torch.core.recovery.RecoveryError` when nothing is
        left."""

    @abc.abstractmethod
    def health(self) -> dict:
        """{"healthy": bool, "degraded": [...], "members": {...}} — shape
        shared across backends, members payload backend-specific."""

    @abc.abstractmethod
    def close(self) -> None:
        """Release resources.  Idempotent."""

    # ------------------------------------------------- optional surface
    def wait(self) -> None:
        """Drain in-flight async work — snapshots AND fired persists
        (no-op where saves are synchronous)."""

    def poll_persists(self) -> list:
        """Non-blocking: collect async persists that completed since the
        last poll (emitting their events); returns completion records.
        Backends without overlapped persistence return []."""
        return []

    def inject_failure(self, node: int = 0, kind: str = "software",
                       **params) -> None:
        """Simulate a failure for drills.  Disk backends interpret any kind
        as 'the training process lost its in-memory state' (a no-op on the
        backend itself); memory-tier backends knock out real members.
        `params` carry kind-specific knobs (grace_s, lag_s, delay_s,
        nbytes, seed — see `repro_torch.supervise.inject.DEFAULT_PARAMS`)."""
        self.emit("inject", -1, detail=f"{kind}:node{node}")

    def heal(self) -> None:
        """Bring failed members back after a recovery (no-op by default)."""

    def launched(self, step: int) -> bool:
        """Whether a capture of `step` went out in part: REFT members whose
        flight slot was busy skip a step the others launch, and the
        recovery ladder can restore such a step (the skipped members from
        parity) although `snapshot()` reported it skipped. False where
        captures go out whole or not at all."""
        return False

    # ------------------------------------------------------- context mgr
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
