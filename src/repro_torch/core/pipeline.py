"""Hierarchical asynchronous snapshot pipeline (HASC, paper §4.1's
"three-level asynchronous on-device scheduling").

The monolithic snapshot thread (read -> CRC -> blocking ring-send per
bucket) is replaced by three cooperating levels, each with its own
backpressure signal, so saving and training contend as little as the
hardware allows:

  L1 device pump    windowed non-blocking d2h prefetch over the
                    upcoming buckets (pinned host copies on a side
                    stream, one event wait per prefetch window),
                    double-buffered scratch fills, a
                    bucket schedule that drains optimizer-moment leaves
                    first, and cooperative yields at training step
                    boundaries (`StepBoundaryGate`).  With
                    ``device_encode`` the pump instead hands each
                    bucket's leaf byte-ranges to the fused CUDA encode
                    kernel (gather + XOR parity + CRC32,
                    `repro_torch.kernels.stage.encode_ranges`), which
                    reads them on the card *before* the d2h copy.
  L2 host stager    moves ready buckets into the SMP staging ring under
                    credit-based flow control: scratch-buffer credits
                    upstream (to L1), ring-slot semaphore credits
                    downstream (from the SMP's bucket consumption).
                    Best-effort pinned to the saving-path CPU set
                    (`ReftConfig.pin_cpus`).
  L3 SMP            event-driven begin/bucket/end over the pipe; the
                    own-region CRC is computed inside the SMP at ``end``
                    (off every trainer-side critical path) — or handed
                    over precombined when the device encode path already
                    produced per-bucket digests; the clean-ack completes
                    the flight.

Multi-flight overlap: with ``max_flights > 1`` snapshot N+1's L1 pump may
start while snapshot N drains L2/L3.  Flights chain on two events —
N+1's pump waits for N's *pump* to finish (so the shared scratch-credit
pool is drained oldest-first, deadlock-free), and N+1's stager waits for
N's clean-ack before ``begin`` (so the SMP never holds two dirty
buffers).  The scratch pool is owned by the pipeline, not the flight, so
scratch memory stays fixed at ``scratch_buffers`` buckets no matter how
many flights are in the air.

The flight keeps `snapshot_async`/`snapshot_sync`/`wait` semantics and the
dirty-never-visible invariant: an aborted flight never sends ``end``, so
the dirty buffer is never published.

Streams (PyTorch port): the trainer's step runs on its current stream and
updates the state out of place, so the leaves a flight pins are never
written again.  `SnapshotPipeline.start` records an event on the trainer's
stream; the pump thread works on a side stream that first waits on that
event, so it never reads a leaf before the step that made it has finished,
and it never blocks the trainer's stream.
"""
from __future__ import annotations

import bisect
import contextlib
import os
import pickle
import queue
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analyze.lockgraph import named_condition
from repro_torch.core.crcutil import crc32_concat
from repro_torch.core.delta import FlightDelta, merge_ranges, task_dirty
from repro_torch.core.spans import span
from repro_torch.core.treebytes import (FlatSpec, dtype_itemsize,
                                        iter_buckets, tensor_u8)

__all__ = [
    "StepBoundaryGate", "step_boundary", "BucketTask", "build_schedule",
    "leaf_budget", "leaf_extents", "LeafReader", "DeviceEncoder",
    "DeviceFence", "HostCopy", "PipelineResult",
    "PipelineFlight", "SnapshotPipeline", "resolve_device_encode",
    "resolve_ranged_fetch",
    "resolve_affinity", "pin_current_thread", "task_local_extent",
    "DeltaBaseMismatch",
]


class DeltaBaseMismatch(RuntimeError):
    """The SMP's latest clean buffer is not the delta flight's base step:
    the flight aborts (nothing published) and the tracker must take a
    keyframe next."""


# ------------------------------------------------------------ L1 yield gate
class StepBoundaryGate:
    """Condition-variable gate the training loop ticks once per step.

    The L1 pump periodically waits for the *next* tick so its bucket bursts
    align with step boundaries instead of racing the forward/backward pass
    for host bandwidth.  The gate only throttles while a trainer is
    actually ticking (`ACTIVE_WINDOW`); a standalone snapshot (benchmarks,
    tests, recovery drills) runs unthrottled.
    """

    ACTIVE_WINDOW = 2.0          # seconds since last tick that count as live

    def __init__(self):
        self._cond = named_condition("pipeline.gate")
        self._tick = 0
        self._last = float("-inf")

    def notify(self) -> None:
        with self._cond:
            self._tick += 1
            self._last = time.monotonic()
            self._cond.notify_all()

    def active(self) -> bool:
        return (time.monotonic() - self._last) < self.ACTIVE_WINDOW

    def wait_boundary(self, timeout: float) -> bool:
        """Wait for the next step boundary; no-op when no trainer is live.
        Returns True if a boundary arrived within `timeout`."""
        if timeout <= 0 or not self.active():
            return False
        with self._cond:
            t = self._tick
            return self._cond.wait_for(lambda: self._tick > t,
                                       timeout=timeout)


GATE = StepBoundaryGate()


def step_boundary() -> None:
    """Signal a training step boundary to every in-flight snapshot pipeline
    (the hook `train.steps.with_step_boundary` and
    `CheckpointSession.after_step` call)."""
    GATE.notify()


# --------------------------------------------------------- mode resolution
def on_device(leaves: Sequence[Any]) -> bool:
    """True when any leaf is a tensor on an accelerator (CUDA)."""
    return any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves)


def resolve_device_encode(cfg, leaves: Sequence[Any] = ()) -> bool:
    """`ReftConfig.device_encode`: "on" forces the device encode path
    (the kernel's plain version on CPU tensors — what CI exercises),
    "off" forces the host path, "auto" enables it exactly when the
    state's leaves live on the card."""
    mode = str(getattr(cfg, "device_encode", "auto")).lower()
    if mode in ("on", "true", "1"):
        return True
    if mode in ("off", "false", "0"):
        return False
    return on_device(leaves)


def resolve_ranged_fetch(cfg, leaves: Sequence[Any] = ()) -> bool:
    """`ReftConfig.ranged_fetch`: slice each leaf down to the byte extent
    a sparse delta flight actually reads *on the device* before the d2h
    copy.  "on"/"off" force it; "auto" enables it exactly when the
    state's leaves live on the card — a host tensor's bytes are already
    a zero-copy view, so slicing first is pure overhead there."""
    mode = str(getattr(cfg, "ranged_fetch", "auto")).lower()
    if mode in ("on", "true", "1"):
        return True
    if mode in ("off", "false", "0"):
        return False
    return on_device(leaves)


class DeviceFence:
    """Orders a flight's side-stream work after the trainer's step.

    Created on the trainer's thread when a flight starts: records an
    event on the trainer's current stream.  `stream()` (entered on the
    pump thread) makes a side stream current that first waits on that
    event.  A no-op for host leaves."""

    def __init__(self, leaves: Sequence[Any]):
        self.event = None
        dev = next((x.device for x in leaves
                    if isinstance(x, torch.Tensor) and x.is_cuda), None)
        if dev is not None:
            self.device = dev
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(dev))

    def stream(self):
        if self.event is None:
            return contextlib.nullcontext()
        side = torch.cuda.Stream(device=self.device)
        side.wait_event(self.event)
        return torch.cuda.stream(side)


class HostCopy:
    """A non-blocking d2h copy of one tensor into pinned host memory,
    started on the current stream; `numpy()` waits for it (CUDA event)
    and returns the host bytes.  Host tensors pass through untouched."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.is_cuda:
            self.host = t.to("cpu", non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return tensor_u8(self.host).numpy()


def resolve_affinity(pin) -> Optional[Tuple[int, ...]]:
    """Saving-path CPU set for the L2 stager thread + SMP process.

    `None`/"off" disables pinning; "auto" reserves the trailing eighth of
    the allowed CPUs on hosts big enough for it to help (>= 8 allowed
    cores — tiny CI runners are left alone); an explicit sequence is
    intersected with the allowed set.  Best-effort: unsupported platforms
    resolve to None."""
    if pin is None or pin is False or pin == "off":   # NB: identity, not
        return None                                   # ==: cpu id 0 != False
    if pin is True:
        pin = "auto"
    if not hasattr(os, "sched_getaffinity"):
        return None
    try:
        avail = sorted(os.sched_getaffinity(0))
    except OSError:
        return None
    if pin == "auto":
        if len(avail) < 8:
            return None
        k = max(1, len(avail) // 8)
        return tuple(avail[-k:])
    try:                                 # best-effort: a malformed knob
        if isinstance(pin, int):         # (bare int, "0,1" string, junk)
            pin = (pin,)                 # must never fail engine setup
        elif isinstance(pin, str):
            pin = pin.replace(",", " ").split()
        cpus = tuple(c for c in (int(x) for x in pin) if c in avail)
    except (TypeError, ValueError):
        return None
    return cpus or None


def pin_current_thread(cpus) -> Optional[Tuple[int, ...]]:
    """Pin the calling thread (Linux: per-thread affinity) to `cpus`.
    Returns the applied set, or None where unsupported/denied."""
    if not cpus or not hasattr(os, "sched_setaffinity"):
        return None
    try:
        os.sched_setaffinity(0, cpus)
        return tuple(sorted(os.sched_getaffinity(0)))
    except (AttributeError, OSError):
        return None


# ------------------------------------------------------------- scheduling
_OPT_MARKERS = ("opt", "mu", "nu", "moment", "adam", "exp_avg")


def _is_opt_path(path: str) -> bool:
    p = path.lower()
    return any(m in p for m in _OPT_MARKERS)


@dataclass(frozen=True)
class BucketTask:
    """One staging-ring bucket: bytes [lo, hi) of the flat stream, written
    at `dst` of the own region (kind 0), XORed into parity (kind 1), or —
    device encode path — the XOR of the stripe's `sources` ranges written
    straight into parity (kind 2, one d2h'd block instead of n-1)."""
    kind: int                    # 0 = own data, 1 = host parity XOR,
                                 # 2 = device-encoded parity write
    dst: int                     # destination offset within the region
    lo: int                      # global flat-stream byte range (kind 2:
    hi: int                      # the first source range)
    leaf_lo: int                 # first/last+1 spec-leaf index overlapped
    leaf_hi: int
    opt: bool                    # bucket starts inside an optimizer leaf
    sources: Tuple[Tuple[int, int], ...] = ()   # kind 2: stripe ranges


def _leaf_span(offsets: Sequence[int], spec: FlatSpec,
               lo: int, hi: int) -> Tuple[int, int]:
    l0 = max(0, bisect.bisect_right(offsets, lo) - 1)
    l1 = bisect.bisect_left(offsets, hi)
    return l0, min(l1, len(spec.leaves))


def task_local_extent(task: BucketTask, own_bytes: int) -> Tuple[int, int]:
    """Buffer-local byte extent a task writes: own-region offset for
    kind 0, parity-region offset (past `own_bytes`) for kinds 1/2."""
    nb = task.hi - task.lo
    if task.kind == 0:
        return (task.dst, task.dst + nb)
    return (own_bytes + task.dst, own_bytes + task.dst + nb)


def build_schedule(spec: FlatSpec,
                   own_plan: Sequence[Tuple[int, int, int]],
                   stripe_plan: Sequence[Tuple[int, int]],
                   bucket_bytes: int, *,
                   opt_first: bool = True,
                   fuse_parity: bool = False,
                   dirty: Optional[Sequence[Tuple[int, int]]] = None):
    """Bucket-split both plans into `BucketTask`s.  With `opt_first`, the
    buckets that start inside optimizer-moment leaves drain first: the
    moments are dead weights until the next optimizer update, so saving
    them first maximises the window in which training may already mutate
    (rebind) the parameter leaves it is about to need.

    With `fuse_parity` (device encode path) the stripe plan becomes one
    kind-2 task per *parity-region* bucket, carrying the n-1 source
    ranges the device kernel XOR-folds — the parity leaves the device
    already encoded, cutting parity d2h traffic by (n-1)x.

    Delta mode: with `dirty` (merged global byte ranges that may have
    changed since the base snapshot) the return value becomes
    ``(tasks, delta_map)`` where `delta_map` maps the index of each
    DIRTY task in the (full) schedule to the buffer-local extent it
    rewrites — tasks absent from the map are clean and a delta flight
    skips them before any read or d2h."""
    offsets = [l.offset for l in spec.leaves]
    tasks: List[BucketTask] = []
    for dst0, lo, hi in own_plan:
        for a, b in iter_buckets(lo, hi, bucket_bytes):
            l0, l1 = _leaf_span(offsets, spec, a, b)
            opt = l0 < len(spec.leaves) and _is_opt_path(spec.leaves[l0].path)
            tasks.append(BucketTask(0, dst0 + (a - lo), a, b, l0, l1, opt))
    if fuse_parity and stripe_plan:
        bases = [lo for lo, _ in stripe_plan]
        bs = stripe_plan[0][1] - stripe_plan[0][0]
        for a, b in iter_buckets(0, bs, bucket_bytes):
            srcs = tuple((base + a, base + b) for base in bases)
            l0, l1 = _leaf_span(offsets, spec, srcs[0][0], srcs[0][1])
            opt = l0 < len(spec.leaves) and _is_opt_path(spec.leaves[l0].path)
            tasks.append(BucketTask(2, a, srcs[0][0], srcs[0][1], l0, l1,
                                    opt, srcs))
    else:
        for lo, hi in stripe_plan:
            for a, b in iter_buckets(lo, hi, bucket_bytes):
                l0, l1 = _leaf_span(offsets, spec, a, b)
                opt = l0 < len(spec.leaves) \
                    and _is_opt_path(spec.leaves[l0].path)
                tasks.append(BucketTask(1, a - lo, a, b, l0, l1, opt))
    if opt_first:
        tasks.sort(key=lambda t: 0 if t.opt else 1)      # stable
    if dirty is None:
        return tasks
    own_bytes = sum(hi - lo for _, lo, hi in own_plan)
    ranges = merge_ranges(dirty)
    delta_map = {i: task_local_extent(t, own_bytes)
                 for i, t in enumerate(tasks) if task_dirty(t, ranges)}
    return tasks, delta_map


def leaf_budget(spec: FlatSpec,
                ranges: Sequence[Tuple[int, int]]) -> Dict[int, int]:
    """Bytes of each leaf this node will ever read, over all plan ranges —
    the eviction budget for `LeafReader` (drop a leaf's host copy the
    moment its last byte is consumed, instead of caching the whole state
    per snapshot)."""
    offsets = [l.offset for l in spec.leaves]
    out: Dict[int, int] = {}
    for lo, hi in ranges:
        l0, l1 = _leaf_span(offsets, spec, lo, min(hi, spec.total_bytes))
        for i in range(l0, l1):
            ls = spec.leaves[i]
            a, b = max(lo, ls.offset), min(hi, ls.offset + ls.nbytes)
            if b > a:
                out[i] = out.get(i, 0) + (b - a)
    return out


def leaf_extents(spec: FlatSpec,
                 ranges: Sequence[Tuple[int, int]]) -> Dict[int, Tuple[int,
                                                                       int]]:
    """Per-leaf [lo, hi) byte extent (relative to the leaf start, aligned
    down/up to the leaf's element size) that covers every plan range — a
    `LeafReader` given extents d2h-transfers only that flat slice of each
    leaf instead of the whole array, so a sparse delta flight pays d2h
    for what changed, not for model size."""
    offsets = [l.offset for l in spec.leaves]
    out: Dict[int, Tuple[int, int]] = {}
    for lo, hi in ranges:
        l0, l1 = _leaf_span(offsets, spec, lo, min(hi, spec.total_bytes))
        for i in range(l0, l1):
            ls = spec.leaves[i]
            a, b = max(lo, ls.offset) - ls.offset, \
                min(hi, ls.offset + ls.nbytes) - ls.offset
            if b <= a:
                continue
            cur = out.get(i)
            out[i] = (a, b) if cur is None else (min(cur[0], a),
                                                 max(cur[1], b))
    for i, (a, b) in out.items():
        ls = spec.leaves[i]
        isz = max(1, dtype_itemsize(ls.dtype))
        out[i] = ((a // isz) * isz, min(-(-b // isz) * isz, ls.nbytes))
    return out


class LeafReader:
    """Random byte-range access over the flat stream with per-snapshot host
    caching (each leaf is device_get at most once per snapshot).  With a
    `budget` ({leaf_idx: bytes that will be read}), a leaf's host copy is
    evicted as soon as its byte ranges are fully consumed, bounding the
    host-cache footprint to the live working set instead of the entire
    state.  With `extents` ({leaf_idx: (rel_lo, rel_hi)}), only that flat
    byte slice of a leaf crosses the d2h link — sparse delta flights hand
    the per-flight extents of their surviving work items here.  `fetch`
    starts a prefetch window's d2h copies together (non-blocking, into
    pinned memory) and waits once, instead of a synchronous per-leaf
    read."""

    def __init__(self, spec: FlatSpec, leaves: List[Any],
                 budget: Optional[Dict[int, int]] = None,
                 extents: Optional[Dict[int, Tuple[int, int]]] = None):
        self.spec = spec
        self.leaves = leaves
        self.offsets = [l.offset for l in spec.leaves]
        self._host: Dict[int, np.ndarray] = {}
        self._base: Dict[int, int] = {}
        self._budget = budget
        self._extents = extents
        self._consumed: Dict[int, int] = {}
        self.batched_fetches = 0

    @staticmethod
    def _as_bytes(arr) -> np.ndarray:
        if isinstance(arr, torch.Tensor):
            return HostCopy(tensor_u8(arr.detach())).numpy()
        return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)

    def _device_slice(self, i: int):
        """The device array (or flat sub-slice) to transfer for leaf `i`,
        plus the byte offset of that slice within the leaf."""
        leaf = self.leaves[i]
        ext = self._extents.get(i) if self._extents else None
        if ext is None:
            return leaf, 0
        ls = self.spec.leaves[i]
        lo, hi = ext
        if lo <= 0 and hi >= ls.nbytes:
            return leaf, 0
        isz = max(1, dtype_itemsize(ls.dtype))
        # reshape(-1) is free (row-major); the slice stays on device so
        # only ext bytes cross the d2h link
        return leaf.reshape(-1)[lo // isz:hi // isz], lo

    def fetch(self, idxs: Sequence[int]) -> None:
        """Batched d2h for every listed leaf not yet cached: start every
        copy (non-blocking, pinned) on the current stream, then wait on
        their events — the L1 pump calls this per prefetch-window advance
        instead of paying a synchronous read per leaf at first touch."""
        missing = [i for i in idxs if i not in self._host]
        if not missing:
            return
        copies = []
        for i in missing:
            dev, base = self._device_slice(i)
            self._base[i] = base
            copies.append(HostCopy(tensor_u8(dev.detach()))
                          if isinstance(dev, torch.Tensor) else dev)
        for i, c in zip(missing, copies):
            self._host[i] = c.numpy() if isinstance(c, HostCopy) \
                else self._as_bytes(c)
        self.batched_fetches += 1

    def _leaf_bytes(self, i: int) -> np.ndarray:
        if i not in self._host:
            dev, base = self._device_slice(i)
            self._base[i] = base
            self._host[i] = self._as_bytes(dev)
        return self._host[i]

    def read(self, lo: int, hi: int, out: np.ndarray) -> None:
        i = bisect.bisect_right(self.offsets, lo) - 1
        pos = lo
        while pos < hi and i < len(self.spec.leaves):
            ls = self.spec.leaves[i]
            a = max(pos, ls.offset)
            b = min(hi, ls.offset + ls.nbytes)
            if b > a:
                hb = self._leaf_bytes(i)
                base = self._base.get(i, 0)
                out[a - lo:b - lo] = hb[a - ls.offset - base:
                                        b - ls.offset - base]
                if self._budget is not None:
                    got = self._consumed.get(i, 0) + (b - a)
                    self._consumed[i] = got
                    if got >= self._budget.get(i, float("inf")):
                        self._host.pop(i, None)
                        self._base.pop(i, None)
            pos = b
            i += 1
        if pos < hi:                                   # zero-pad past end
            out[pos - lo:hi - lo] = 0

    def cached_leaves(self) -> int:
        return len(self._host)


# --------------------------------------------------------- device encoder
class DeviceEncoder:
    """Device-side bucket encode for one flight: hands a `BucketTask`'s
    scattered leaf byte-ranges (uint8 views of the pinned leaves) to the
    fused encode kernel (`repro_torch.kernels.stage.encode_ranges`), which
    reads them where they lie on the card — XOR parity fold for kind-2
    buckets, CRC32 for own-data buckets — and starts the d2h copy.  The
    host receives ready-to-publish bytes + digest; no gather copy, no
    per-leaf host gather, no host XOR, no host zlib."""

    def __init__(self, spec: FlatSpec, leaves: List[Any]):
        from repro_torch.kernels.stage import (LANE_BYTES, bucket_crc,
                                               encode_ranges)
        self._lane_bytes = LANE_BYTES
        self._encode = encode_ranges
        self._bucket_crc = bucket_crc
        self.spec = spec
        self.leaves = leaves
        self.offsets = [l.offset for l in spec.leaves]
        self._u8cache: Dict[int, Any] = {}

    def _u8(self, i: int) -> torch.Tensor:
        got = self._u8cache.get(i)
        if got is None:
            got = self._u8cache[i] = tensor_u8(self.leaves[i].detach())
        return got

    def ranges(self, lo: int, hi: int) -> List[Tuple[torch.Tensor, int,
                                                      int]]:
        """Bytes [lo, hi) of the flat stream as `(uint8 leaf view, start,
        count)` slices in order; bytes past `total_bytes` have none."""
        out = []
        i = bisect.bisect_right(self.offsets, lo) - 1
        pos = lo
        while pos < hi and i < len(self.spec.leaves):
            ls = self.spec.leaves[i]
            a, b = max(pos, ls.offset), min(hi, ls.offset + ls.nbytes)
            if b > a:
                out.append((self._u8(i), a - ls.offset, b - a))
            pos = b
            i += 1
        return out

    def gather_bytes(self, lo: int, hi: int) -> torch.Tensor:
        """Bytes [lo, hi) of the flat stream as a fresh uint8 tensor on the
        leaves' device, zero-padded past `total_bytes` and up to whole
        `LANE_BYTES` lanes (what `encode_ranges` reads in place)."""
        parts = [t[a:a + n] for t, a, n in self.ranges(lo, hi)]
        pad = (hi - lo - sum(p.numel() for p in parts)) \
            + ((lo - hi) % self._lane_bytes)
        if pad:
            dev = parts[0].device if parts else self.leaves[0].device
            parts.append(torch.zeros(pad, dtype=torch.uint8, device=dev))
        # always a fresh buffer: a bare leaf slice may start at any byte,
        # and the lane view and the kernel need aligned storage
        return parts[0].clone() if len(parts) == 1 else torch.cat(parts)

    def encode(self, task: BucketTask, *, want_crc: Optional[bool] = None,
               prewarm_payload: bool = True):
        """Launch the fused encode for `task` on the current stream;
        returns (lanes, crc, nbytes) where `crc` is a started `HostCopy`
        and `lanes` is one too when `prewarm_payload`, else the device
        tensor.  The delta path forces `want_crc=True` even for parity
        buckets (the digest of the XOR fold is the skip signal) and
        defers the payload copy until the digest compare rules the
        bucket dirty — a clean bucket then d2h's 4 bytes, not the
        bucket."""
        nb = task.hi - task.lo
        if task.kind == 2:
            sources = task.sources
            if want_crc is None:
                want_crc = False             # parity carries no checksum
        else:
            sources = ((task.lo, task.hi),)
            want_crc = True
        # a RAIM5 block may end in the pad past total_bytes: a row there
        # has no slice and encodes as zeros
        lanes, crc = self._encode([self.ranges(lo, hi) for lo, hi in sources],
                                  nbytes=nb, want_crc=want_crc,
                                  device=self.leaves[0].device)
        crc = HostCopy(crc)
        if prewarm_payload:
            lanes = HostCopy(lanes)
        return lanes, crc, nb

    def bucket_crc(self, crc, nbytes: int) -> int:
        """Digest array (single-cell or per-tile, already on host) -> the
        bucket's zlib-compatible CRC32 (crc32_combine fold for tiles)."""
        return self._bucket_crc(crc, nbytes)


# --------------------------------------------------------------- flights
@dataclass(frozen=True)
class PipelineResult:
    """Per-flight outcome with the per-level timing decomposition."""
    step: int
    clean_step: int
    bytes_sent: int
    l1_seconds: float            # device->host reads (+ prefetch issue)
    l1_stall_seconds: float      # waiting for a scratch-buffer credit
    l2_seconds: float            # staging-ring writes incl. slot waits
    l3_seconds: float            # begin/end signaling + SMP clean-ack
    wall_seconds: float
    # ---- dirty-delta bookkeeping (delta-enabled pipelines only)
    skipped_buckets: int = 0     # buckets never sent (provider or digest)
    delta_base: Optional[int] = None    # base step of a delta flight
    digests: Optional[Dict[int, int]] = None   # task idx -> bucket CRC32
    sent_extents: Tuple[Tuple[int, int], ...] = ()   # buffer-local, merged


_STOP = object()


class PipelineFlight:
    """One in-flight snapshot: an L1 pump thread and an L2 stager thread
    joined by credit queues.  `wait` never drops a live flight (a timeout
    raises and the flight stays current), and an aborted flight never
    sends `end`, so a half-written dirty buffer is never published.

    Scratch credits come from the owning pipeline's SHARED pool; `prev`
    chains multi-flight overlap (see module docstring): this flight's
    pump starts after `prev`'s pump finished, its stager `begin`s after
    `prev`'s clean-ack."""

    def __init__(self, smp, spec: FlatSpec, cfg, schedule: List[BucketTask],
                 budget: Dict[int, int], leaves: List[Any], step: int,
                 extra_meta: dict, *, free: "queue.Queue",
                 prev: "Optional[PipelineFlight]" = None,
                 encoder: Optional[DeviceEncoder] = None,
                 affinity: Optional[Tuple[int, ...]] = None,
                 pipeline: "Optional[SnapshotPipeline]" = None,
                 delta: Optional[FlightDelta] = None,
                 want_digests: bool = False,
                 fence: Optional[DeviceFence] = None,
                 record: Any = None):
        self.smp, self.spec, self.cfg = smp, spec, cfg
        # the engine's record of this flight: its `landed_at` is set to
        # the monotonic time at which the SMP acknowledged the step clean
        self.record = record
        self.fence = fence if fence is not None else DeviceFence(leaves)
        self.schedule, self.budget = schedule, budget
        self.leaves, self.step, self.extra_meta = leaves, step, extra_meta
        self.prev = prev
        self.encoder = encoder
        self.affinity = affinity
        self.pipeline = pipeline
        self.delta = delta
        # keyframe flights of a delta-enabled pipeline still digest every
        # bucket: their table is the next delta's compare base
        self.want_digests = want_digests or delta is not None
        self._digests: Dict[int, int] = {}   # full-schedule idx -> CRC32
        self._skipped = 0
        self.result: Optional[PipelineResult] = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.pump_done = threading.Event()
        self._abort = threading.Event()
        # set while a caller is blocked in wait(): the trainer cannot tick
        # step boundaries then, so the pump must not wait for them
        self._draining = threading.Event()
        self._free = free                       # SHARED scratch-credit pool
        self._ready: "queue.Queue" = queue.Queue()
        self._l1_read = 0.0
        self._l1_stall = 0.0
        self._t0 = time.perf_counter()
        self._pump_t = threading.Thread(target=self._pump, daemon=True,
                                        name=f"hasc-l1-s{step}")
        self._stage_t = threading.Thread(target=self._stage, daemon=True,
                                         name=f"hasc-l2-s{step}")

    def launch(self) -> "PipelineFlight":
        self._stage_t.start()
        self._pump_t.start()
        return self

    # ------------------------------------------------------------- L1
    def _get_credit(self):
        with span("reft.l1.stall"):
            while True:
                try:
                    t0 = time.perf_counter()
                    buf = self._free.get(timeout=0.5)
                    self._l1_stall += time.perf_counter() - t0
                    return buf
                except queue.Empty:
                    self._l1_stall += 0.5
                    if self._abort.is_set():
                        raise RuntimeError(
                            "snapshot pipeline aborted") from None

    def _wait_event(self, ev: threading.Event, what: str) -> None:
        while not ev.wait(0.5):
            if self._abort.is_set():
                raise RuntimeError(
                    f"snapshot pipeline aborted while waiting for {what}")

    def _pump(self):
        try:
            prev = self.prev               # local: the stager clears the
            if prev is not None:           # attr once this flight is done
                # multi-flight: consume shared scratch credits strictly
                # oldest-flight-first (no two pumps compete for the pool,
                # so the older flight can always finish draining)
                self._wait_event(prev.pump_done, "predecessor pump")
            with self.fence.stream():
                if self.encoder is not None:
                    self._pump_device()
                else:
                    self._pump_host()
        except BaseException as e:
            if self.error is None:
                self.error = e
            self._abort.set()
        finally:
            self.pump_done.set()
            self._ready.put(_STOP)
            if self.done.is_set():
                self._release()

    def _work_items(self) -> List[Tuple[int, BucketTask]]:
        """(full-schedule idx, task) pairs the pump must actually read —
        provider-skipped buckets are dropped HERE, before any prefetch
        or `device_get`, and inherit the base flight's digest."""
        delta = self.delta
        if delta is None or not delta.skip:
            return list(enumerate(self.schedule))
        out = []
        for i, task in enumerate(self.schedule):
            if i in delta.skip:
                self._digests[i] = delta.prev.get(i, 0)
                self._skipped += 1
            else:
                out.append((i, task))
        return out

    def _pump_host(self):
        window = max(1, getattr(self.cfg, "prefetch_window", 4))
        yield_every = max(0, getattr(self.cfg, "yield_every_buckets", 4))
        yield_timeout = getattr(self.cfg, "boundary_timeout_s", 0.005)
        work = self._work_items()
        budget, extents = self.budget, None
        if self.delta is not None and len(work) < len(self.schedule):
            # sparse flight: rebuild the read plan from the SURVIVING
            # work items so (a) eviction matches what is actually read
            # and (b) only the touched byte extents of each leaf cross
            # the d2h link — pay for what changed, not for model size
            spans: List[Tuple[int, int]] = []
            for _, t in work:
                if t.kind == 2 and t.sources:
                    spans.extend(t.sources)
                else:
                    spans.append((t.lo, t.hi))
            spans = merge_ranges(spans)
            budget = leaf_budget(self.spec, spans)
            if self.pipeline is not None and self.pipeline.ranged_fetch:
                extents = leaf_extents(self.spec, spans)
        reader = LeafReader(self.spec, self.leaves, budget, extents)
        issued: set = set()
        fold = None               # host XOR scratch for fused kind-2 tasks
        for w, (i, task) in enumerate(work):
            if self._abort.is_set():
                raise RuntimeError("snapshot pipeline aborted")
            with span("reft.l1.read"):
                t0 = time.perf_counter()
                fresh = []
                for _, nxt in work[w:w + window]:      # windowed prefetch
                    spans = [(nxt.leaf_lo, nxt.leaf_hi)]
                    if nxt.kind == 2 and nxt.sources:
                        # fused parity reads every stripe source range,
                        # not just the first one the task's leaf span
                        # covers — prefetch them all or each falls back
                        # to a synchronous per-leaf device_get mid-read
                        spans = [_leaf_span(reader.offsets, self.spec, lo,
                                            hi) for lo, hi in nxt.sources]
                    for l0, l1 in spans:
                        for li in range(l0, l1):
                            if li not in issued:
                                issued.add(li)
                                fresh.append(li)
                if fresh:
                    reader.fetch(fresh)     # one batched d2h for the window
                self._l1_read += time.perf_counter() - t0
            if yield_every and w and w % yield_every == 0 \
                    and not self._draining.is_set():
                GATE.wait_boundary(yield_timeout)  # yield to training
            buf = self._get_credit()
            nb = task.hi - task.lo
            with span("reft.l1.read"):
                t0 = time.perf_counter()
                try:
                    if task.kind == 2 and task.sources:
                        # host-side fused parity: fold the n-1 stripe
                        # source ranges so the ring carries ONE
                        # pre-encoded block
                        reader.read(task.sources[0][0], task.sources[0][1],
                                    buf[:nb])
                        if fold is None:
                            fold = np.empty(self.cfg.bucket_bytes, np.uint8)
                        for lo, hi in task.sources[1:]:
                            reader.read(lo, hi, fold[:nb])
                            np.bitwise_xor(buf[:nb], fold[:nb],
                                           out=buf[:nb])
                    else:
                        reader.read(task.lo, task.hi, buf[:nb])
                except BaseException:
                    self._free.put(buf)                # never leak a credit
                    raise
                self._l1_read += time.perf_counter() - t0
            # host digests (and the digest-compare skip) run in the L2
            # stager, not here: L1 is the device-read level and stays
            # read-only — the device path keeps CRC on the accelerator
            # for the same reason
            self._ready.put((task, buf, buf[:nb], nb, None, i))

    def _pump_device(self):
        enc = self.encoder
        window = max(1, getattr(self.cfg, "prefetch_window", 4))
        yield_every = max(0, getattr(self.cfg, "yield_every_buckets", 4))
        yield_timeout = getattr(self.cfg, "boundary_timeout_s", 0.005)
        delta = self.delta
        digesting = self.want_digests
        # digest compare pending: hold the payload d2h until the 4-byte
        # digest ruled the bucket dirty
        defer = delta is not None and delta.digest
        work = self._work_items()
        pending: Dict[int, tuple] = {}
        for w, (i, task) in enumerate(work):
            if self._abort.is_set():
                raise RuntimeError("snapshot pipeline aborted")
            with span("reft.l1.read"):
                t0 = time.perf_counter()
                for x in range(w, min(w + window, len(work))):
                    j, tj = work[x]
                    if j not in pending:       # encode a window ahead; the
                        pending[j] = enc.encode(  # kernels + d2h run async
                            tj, want_crc=True if digesting else None,
                            prewarm_payload=not defer)
                self._l1_read += time.perf_counter() - t0   # under this loop
            if yield_every and w and w % yield_every == 0 \
                    and not self._draining.is_set():
                GATE.wait_boundary(yield_timeout)
            lanes, crc, nb = pending.pop(i)
            with span("reft.l1.read"):
                t0 = time.perf_counter()
                crc_val = enc.bucket_crc(crc.numpy().view(np.uint32), nb) \
                    if digesting or task.kind == 0 else None
                if digesting:
                    self._digests[i] = crc_val
                same = defer and delta.prev.get(i) == crc_val
                self._l1_read += time.perf_counter() - t0
            if same:
                self._skipped += 1         # clean: only the digest d2h'd
                continue
            buf = self._get_credit()       # token: bounds queued buckets
            with span("reft.l1.read"):
                t0 = time.perf_counter()
                try:
                    if defer:                  # dirty after all: copy now
                        lanes = HostCopy(lanes)
                    payload = lanes.numpy()[:nb]       # d2h (started early)
                except BaseException:
                    self._free.put(buf)
                    raise
                self._l1_read += time.perf_counter() - t0
            self._ready.put((task, buf, payload, nb,
                             crc_val if task.kind == 0 else None, i))

    # ------------------------------------------------------------- L2
    def _stage(self):
        try:
            applied = pin_current_thread(self.affinity)
            if self.pipeline is not None and applied is not None:
                self.pipeline.applied_affinity = applied
            t_l2 = 0.0
            sent = 0
            crcs: List[Tuple[int, int, int]] = []      # (dst, nbytes, crc)
            extents: List[Tuple[int, int]] = []        # buffer-local, sent
            own_bytes = self.smp.layout.own_bytes
            delta = self.delta
            prev = self.prev
            if prev is not None:
                # the SMP holds at most one dirty buffer: begin only after
                # the predecessor's clean-ack (its stager is done with the
                # pipe, so the conn is ours alone from here)
                self._wait_event(prev.done, "predecessor clean-ack")
            with span("reft.l3.signal"):
                t0 = time.perf_counter()
                if delta is not None:
                    # confirmed exchange: the SMP seeds the new shard
                    # buffer by copying the base (latest clean) buffer —
                    # if the base rotated away the delta would publish
                    # garbage, so a miss aborts the flight (nothing
                    # published)
                    if not self.smp.begin(self.step,
                                          base_step=delta.base_step):
                        raise DeltaBaseMismatch(
                            f"delta base step {delta.base_step} is not "
                            f"the SMP's latest clean buffer")
                else:
                    self.smp.begin(self.step)
                t_l3 = time.perf_counter() - t0
            host_digesting = self.want_digests and self.encoder is None
            while True:
                item = self._ready.get()
                if item is _STOP:
                    break
                task, buf, payload, nb, crc_val, idx = item
                with span("reft.l2.write"):
                    t0 = time.perf_counter()
                    if host_digesting:
                        # host digests (and the bit-identical skip) happen
                        # at this level: the pump hands raw reads over and
                        # never pays the CRC pass on the device-read path
                        crc_val = zlib.crc32(payload) & 0xFFFFFFFF
                        self._digests[idx] = crc_val
                        if delta is not None and delta.digest \
                                and delta.prev.get(idx) == crc_val:
                            self._skipped += 1   # bit-identical: skip send
                            self._free.put(buf)
                            t_l2 += time.perf_counter() - t0
                            continue
                        if task.kind != 0:
                            crc_val = None
                    try:
                        self.smp.send_bucket(task.kind, task.dst, payload)
                    finally:
                        self._free.put(buf)            # return the credit
                    t_l2 += time.perf_counter() - t0
                sent += nb
                if crc_val is not None:
                    crcs.append((task.dst, nb, crc_val))
                if self.want_digests:
                    extents.append(task_local_extent(task, own_bytes))
            if self._abort.is_set():                   # no `end`: dirty
                return                                 # buffer stays unseen
            meta = {"spec": self.spec.to_json(), "step": self.step,
                    "extra": self.extra_meta}
            with span("reft.l3.signal"):
                t0 = time.perf_counter()
                if self.want_digests:
                    # delta-enabled pipeline: the full-schedule digest table
                    # covers every own-data bucket (fresh for read buckets,
                    # inherited for skipped ones), so the own-region CRC and
                    # the per-stripe table are derived trainer-side even when
                    # only a handful of buckets were re-sent
                    crcs = [(t.dst, t.hi - t.lo, self._digests[i])
                            for i, t in enumerate(self.schedule)
                            if t.kind == 0]
                if crcs:
                    # device encode path: per-bucket digests -> one combined
                    # own-region CRC plus the per-stripe table (one digest per
                    # local RAIM5 block; buckets never cross block boundaries,
                    # so grouping by dst // bs folds exactly); the SMP skips
                    # its zlib pass on both
                    crcs.sort()
                    crc_own = crc32_concat((c, nb) for _, nb, c in crcs)
                    lay = self.smp.layout
                    seg = lay.bs if lay.n > 1 else lay.own_bytes
                    per_block: Dict[int, List[Tuple[int, int]]] = {}
                    for dst, nb, c in crcs:
                        per_block.setdefault(dst // seg, []).append((c, nb))
                    stripes = [crc32_concat(per_block[k])
                               for k in sorted(per_block)]
                    self.smp.end(self.step, pickle.dumps(meta),
                                 crc_own=crc_own, crc_stripes=stripes)
                else:
                    self.smp.end(self.step, pickle.dumps(meta), want_crc=True)
                clean = self.smp.wait_clean()
                if self.record is not None:
                    self.record.landed_at = time.monotonic()
                t_l3 += time.perf_counter() - t0
            self.result = PipelineResult(
                step=self.step, clean_step=clean, bytes_sent=sent,
                l1_seconds=self._l1_read, l1_stall_seconds=self._l1_stall,
                l2_seconds=t_l2, l3_seconds=t_l3,
                wall_seconds=time.perf_counter() - self._t0,
                skipped_buckets=self._skipped,
                delta_base=None if delta is None else delta.base_step,
                digests=dict(self._digests) if self.want_digests else None,
                sent_extents=tuple(merge_ranges(extents))
                if self.want_digests else ())
        except BaseException as e:
            if self.error is None:
                self.error = e
            self._abort.set()
        finally:
            self._drain_ready()            # return credits of unsent items
            self.done.set()
            self.prev = None               # release the predecessor (and
                                           # its pinned leaves) promptly
            if self.pump_done.is_set():
                self._release()

    def _release(self) -> None:
        """Drop the pinned state once both levels are through with it
        (whichever finishes second calls this): the pipeline keeps its
        newest flight, so a finished flight must not keep the trainer's
        last state alive."""
        self.leaves = self.encoder = None

    def _drain_ready(self) -> None:
        while True:
            try:
                item = self._ready.get_nowait()
            except queue.Empty:
                return
            if item is not _STOP:
                self._free.put(item[1])

    # ----------------------------------------------------------- public
    def in_flight(self) -> bool:
        return not self.done.is_set()

    def wait(self, timeout: float = 300.0) -> PipelineResult:
        """Idempotent: a finished flight re-raises its stored error (or
        returns its result) on every call, so callers can distinguish
        'still live' (the wait-timeout below) from 'failed with an internal
        TimeoutError like an SMP ack timeout' by re-collecting after
        checking `in_flight()`."""
        self._draining.set()
        try:
            if not self.done.wait(timeout):
                raise TimeoutError(
                    f"snapshot pipeline for step {self.step} still in "
                    f"flight after {timeout:.1f}s")
        finally:
            if not self.done.is_set():     # timed out: trainer resumes,
                self._draining.clear()     # boundary yields matter again
        self._pump_t.join(timeout=5.0)
        self._stage_t.join(timeout=5.0)
        self._drain_ready()                # pump items raced past the stager
        if self.error is not None:
            raise self.error
        assert self.result is not None
        return self.result


class SnapshotPipeline:
    """Per-engine HASC controller: owns the (static) bucket schedule, leaf
    budget, the SHARED scratch-credit pool, and the flight chain.
    `start` launches a `PipelineFlight`; with `cfg.max_flights > 1` a new
    flight may launch while predecessors drain (overlap), chained so
    credits drain oldest-first and the SMP sees one dirty buffer."""

    def __init__(self, smp, spec: FlatSpec, cfg,
                 own_plan: Sequence[Tuple[int, int, int]],
                 stripe_plan: Sequence[Tuple[int, int]],
                 leaves: Sequence[Any] = ()):
        self.smp, self.spec, self.cfg = smp, spec, cfg
        # `leaves`: the state template's, to decide where the state lives
        self.device_encode = resolve_device_encode(cfg, leaves)
        self.ranged_fetch = resolve_ranged_fetch(cfg, leaves)
        self.max_flights = max(1, int(getattr(cfg, "max_flights", 1)))
        self.delta_enabled = bool(getattr(cfg, "delta", False))
        # delta mode always fuses parity (host path included): a delta
        # flight refreshes affected parity extents with fully-folded plain
        # writes — XOR-accumulate (kind 1) would need the base parity
        # zeroed first, which the base-copy begin precisely must not do
        self.schedule = build_schedule(
            spec, own_plan, stripe_plan, cfg.bucket_bytes,
            opt_first=getattr(cfg, "opt_first", True),
            fuse_parity=self.device_encode or self.delta_enabled)
        self.budget = leaf_budget(
            spec, [(lo, hi) for _, lo, hi in own_plan] + list(stripe_plan))
        self.scratch_buffers = max(1, getattr(cfg, "scratch_buffers", 2))
        self._free: "queue.Queue" = queue.Queue()
        for _ in range(self.scratch_buffers):
            self._free.put(self._new_credit())
        self.affinity = resolve_affinity(getattr(cfg, "pin_cpus", None))
        self.applied_affinity: Optional[Tuple[int, ...]] = None
        self._last: Optional[PipelineFlight] = None

    def _new_credit(self):
        # host path: a real scratch bucket; device path: the scratch lives
        # on the accelerator, the credit is a pure flow-control token
        return None if self.device_encode \
            else np.empty(self.cfg.bucket_bytes, np.uint8)

    def _replenish(self) -> None:
        """Top the shared pool back up (idle only): a flight that died
        mid-drain may have stranded credits with its corpse."""
        while self._free.qsize() < self.scratch_buffers:
            self._free.put(self._new_credit())

    def live_flights(self) -> int:
        n, f = 0, self._last
        while f is not None and f.in_flight():
            n += 1
            f = f.prev
        return n

    def start(self, leaves: List[Any], step: int, extra_meta: dict,
              delta: Optional[FlightDelta] = None,
              record: Any = None) -> PipelineFlight:
        if self.live_flights() >= self.max_flights:
            # the engine refuses before calling; this is the backstop for
            # direct callers — the flight chain (and the SMP's triple
            # buffer) is sized for max_flights
            raise RuntimeError(
                f"max_flights={self.max_flights} snapshots already in "
                f"flight")
        prev = self._last if (self._last is not None
                              and self._last.in_flight()) else None
        if prev is None:
            self._replenish()
        encoder = DeviceEncoder(self.spec, leaves) \
            if self.device_encode else None
        flight = PipelineFlight(
            self.smp, self.spec, self.cfg, self.schedule, self.budget,
            leaves, step, extra_meta, free=self._free, prev=prev,
            encoder=encoder, affinity=self.affinity, pipeline=self,
            delta=delta, want_digests=self.delta_enabled,
            fence=DeviceFence(leaves), record=record)
        self._last = flight
        return flight.launch()
