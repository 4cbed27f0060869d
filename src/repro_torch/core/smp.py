"""Snapshot Management Process (paper §4.2).

The SMP is a real OS process whose lifecycle is independent of the training
process.  Data flow (Figure 6): the trainer writes tiny buckets into a
shared-memory staging ring; the SMP copies data buckets into the *dirty*
snapshot buffer and XOR-accumulates parity-stripe buckets straight into the
dirty buffer's parity area ("intermediary tensors are released after use").
On `end`, the dirty buffer becomes the new *clean* snapshot.  Three buffers
rotate (dirty / clean / previous-clean) — the paper's "at most 3x" memory
bound — so survivors always share at least one common consistent step even
if a node dies mid-snapshot.

Buffers live in *named* POSIX shared memory, so recovery can read a dead
trainer's clean snapshot without the trainer, and the coordinator can
RAIM5-decode across surviving nodes' segments.  Node failure is simulated
by killing the SMP and unlinking its segments.
"""
from __future__ import annotations

import os
import pickle
import queue
import struct
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass
from multiprocessing import get_context
from multiprocessing.shared_memory import SharedMemory
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analyze.lockgraph import named_condition, named_lock
from repro_torch.analyze.protocol import (ProtocolViolation, ServerValidator,
                                    TraceValidator)
from repro_torch.core import raim5
from repro_torch.core.crcutil import crc32_concat

_MP = get_context("spawn")

NBUF = 3
CTL_SLOTS = 2 + 2 * NBUF      # [magic, latest_clean_idx, (step,state)*NBUF]
ST_FREE, ST_DIRTY, ST_CLEAN = 0, 1, 2
MAGIC = 0x5EF7
META_SLOT = 1 << 20           # per-buffer metadata slot (step-consistent)
PERSIST_CHUNK_BYTES = 8 << 20  # REFT-Ckpt streamed-write granularity


def _seg(run: str, node: int, what: str) -> str:
    return f"reft-{run}-n{node}-{what}"


import inspect as _inspect

_HAS_TRACK = "track" in _inspect.signature(SharedMemory.__init__).parameters

if not _HAS_TRACK:
    # Python < 3.13 has no SharedMemory(track=False): every process that
    # maps a segment registers it with the resource tracker, which then
    # unlinks it behind our back (and races other processes' messages into
    # noisy KeyErrors).  REFT segments must outlive any single process —
    # that is the whole point of the SMP design — and their lifetime is
    # managed explicitly via unlink_node(), so exempt exactly our
    # namespace from tracking in every process that imports this module.
    from multiprocessing import resource_tracker as _rt

    def _exempt(fn):
        def wrapped(name, rtype):
            if rtype == "shared_memory" and str(name).lstrip("/") \
                    .startswith("reft-"):
                return
            return fn(name, rtype)
        return wrapped

    if not getattr(_rt, "_reft_exempt", False):
        _rt.register = _exempt(_rt.register)
        _rt.unregister = _exempt(_rt.unregister)
        _rt._reft_exempt = True


class _Shm(SharedMemory):
    """SharedMemory that never registers with the resource tracker (see
    above / `track=False` on modern Pythons) and tolerates numpy views
    still alive at interpreter exit (close is always attempted explicitly
    first; this only silences the cosmetic late-GC BufferError)."""

    def __init__(self, name=None, create=False, size=0, track=False):
        if _HAS_TRACK:
            super().__init__(name=name, create=create, size=size, track=track)
        else:
            super().__init__(name=name, create=create, size=size)

    def __del__(self):
        try:
            super().__del__()
        except BufferError:
            pass


def _create(name: str, size: int) -> SharedMemory:
    try:
        old = _Shm(name=name, track=False)
        old.close()
        old.unlink()
    except FileNotFoundError:
        pass
    return _Shm(name=name, create=True, size=max(size, 1), track=False)


def _attach(name: str) -> SharedMemory:
    return _Shm(name=name, track=False)


@dataclass(frozen=True)
class NodeLayout:
    """Byte layout of one node's snapshot buffer for an SG of n nodes."""
    n: int
    total_bytes: int            # full state W of the SG

    @property
    def bs(self) -> int:
        return raim5.block_size(self.total_bytes, self.n) if self.n > 1 else \
            self.total_bytes

    @property
    def own_bytes(self) -> int:
        return (self.n - 1) * self.bs if self.n > 1 else self.total_bytes

    @property
    def parity_bytes(self) -> int:
        return self.bs if self.n > 1 else 0

    @property
    def buf_bytes(self) -> int:
        return self.own_bytes + self.parity_bytes


# ---------------------------------------------------------------- process
def _smp_main(conn, run: str, node: int, n: int, total_bytes: int,
              stage_slots: int, bucket_bytes: int, sem, pin_cpus=None,
              trace: bool = False):
    if pin_cpus:
        try:                       # best-effort NUMA/CPU pinning: keep the
            os.sched_setaffinity(0, pin_cpus)   # SMP off the trainer cores
        except (AttributeError, OSError):
            pass
    lay = NodeLayout(n, total_bytes)
    stage = _create(_seg(run, node, "stage"), stage_slots * bucket_bytes)
    bufs = [_create(_seg(run, node, f"buf{i}"), lay.buf_bytes)
            for i in range(NBUF)]
    ctl_shm = _create(_seg(run, node, "ctl"), CTL_SLOTS * 8)
    ctl = np.ndarray((CTL_SLOTS,), np.int64, ctl_shm.buf)
    ctl[:] = 0
    ctl[0] = MAGIC
    ctl[1] = -1                                    # no clean buffer yet
    meta_shm = _create(_seg(run, node, "meta"), NBUF * META_SLOT)

    stage_np = np.ndarray((stage_slots, bucket_bytes), np.uint8, stage.buf)
    buf_np = [np.ndarray((lay.buf_bytes,), np.uint8, b.buf) for b in bufs]

    # L3 readiness event: the trainer-side handle blocks on this message
    # instead of sleep-polling shm_open until the segments appear
    # analyze: ok ANZ003 — pre-thread: worker not started, sole sender
    conn.send(("ready",))

    # REFT-Ckpt runs on a background thread so the message loop keeps
    # draining bucket/end traffic during the disk write + fsync.  A buffer
    # being written carries a *persist pin*: `begin` never selects a
    # pinned buffer as dirty, so the shard on its way to disk can never be
    # re-dirtied mid-write.  The pin is taken HERE, in the message loop,
    # before the job is queued — synchronous with begin/end, no race.
    send_lock = named_lock("smp.server.send")   # loop thread + worker
    pin_cond = named_condition("smp.server.pin")
    # pin REFCOUNTS, not a set: two queued persists may select the SAME
    # buffer (e.g. two rounds at one common step) — the pin must hold
    # until the LAST job over that buffer finishes, or `begin` would
    # re-dirty it under the still-queued second write
    pinned: Dict[int, int] = {}
    persist_q: "queue.Queue" = queue.Queue()

    def _send(msg) -> None:
        with send_lock:
            conn.send(msg)

    def _persist_worker():
        while True:
            job = persist_q.get()
            if job is None:
                return
            seq, path, idx, step, delay_s, opts = job
            opts = opts or {}
            try:
                if delay_s:                  # simulated slow durable tier
                    # analyze: ok ANZ007 — injected latency, not polling
                    time.sleep(delay_s)      # (tests / interference bench)
                # one token bucket covers the local stream AND the remote
                # upload: persist_bw_limit bounds the SMP's total write
                # pressure against a co-located trainer
                bucket = (_TokenBucket(opts["bw_limit"])
                          if opts.get("bw_limit") else None)
                throttle = bucket.consume if bucket else None
                head_blob, digests = _head_and_meta(node, lay, idx, step,
                                                    meta_shm)
                delta = opts.get("delta")
                if delta is not None:
                    # dirty-delta persist: the shard object carries only
                    # the buffer-local extents rewritten since
                    # `base_step`, but the head keeps the FULL merged
                    # meta + per-stripe digest table, so a chain-resolved
                    # read verifies exactly like a full shard
                    extents = [(int(a), int(b))
                               for a, b in delta.get("extents", ())]
                    head = pickle.loads(head_blob)
                    head["base_step"] = int(delta["base_step"])
                    head["extents"] = extents
                    head_blob = pickle.dumps(head)
                    digests["base_step"] = int(delta["base_step"])
                    digests["extents"] = extents
                    _persist_delta_buffer(path, buf_np[idx], extents, seq,
                                          head_blob, throttle=throttle)
                else:
                    _persist_buffer(path, node, lay, idx, step, buf_np,
                                    meta_shm, seq, head_blob=head_blob,
                                    throttle=throttle)
                info = {}
                remote = opts.get("remote")
                if remote:
                    # tier-4: stream the same pinned buffer to the object
                    # store, one multipart part per RAIM5 stripe block —
                    # still on this worker thread, snapshots keep flowing
                    from repro_torch.store import store_from_config
                    store = store_from_config(remote["store"])
                    if delta is not None:
                        from repro_torch.store import upload_delta
                        up = upload_delta(store, remote["key"], head_blob,
                                          buf_np[idx], extents,
                                          retry=remote.get("retry"),
                                          throttle=throttle)
                    else:
                        from repro_torch.store import upload_shard
                        seg = lay.bs if lay.n > 1 else lay.own_bytes
                        up = upload_shard(store, remote["key"], head_blob,
                                          buf_np[idx], seg, lay.own_bytes,
                                          retry=remote.get("retry"),
                                          throttle=throttle)
                    up.update(digests)
                    info["upload"] = up
                if bucket:
                    info["throttle_s"] = bucket.throttled_s
                if trace:
                    why = ServerValidator.on_persist_done(
                        idx, step, int(ctl[2 + 2 * idx]),
                        int(ctl[3 + 2 * idx]) == ST_CLEAN)
                    if why:
                        _send(("protocol-error", why))
                reply = ("persisted", seq, path, step, info)
            except Exception as e:
                reply = ("persist-error", seq, repr(e))
            finally:
                unpin_why = None
                with pin_cond:
                    if trace:
                        unpin_why = ServerValidator.on_unpin(
                            idx, pinned.get(idx, 0))
                    left = pinned.get(idx, 1) - 1
                    if left <= 0:
                        pinned.pop(idx, None)
                    else:
                        pinned[idx] = left
                    pin_cond.notify_all()
                if unpin_why:
                    try:
                        _send(("protocol-error", unpin_why))
                    except (BrokenPipeError, OSError):
                        pass                 # trainer gone
            try:
                _send(reply)
            except (BrokenPipeError, OSError):
                pass                         # trainer gone; keep serving

    worker = threading.Thread(target=_persist_worker, daemon=True,
                              name=f"smp-persist-n{node}")
    worker.start()

    dirty = -1
    try:
        while True:
            msg = conn.recv()
            op = msg[0]
            if op == "begin":
                step = msg[1]
                base_step = msg[2] if len(msg) > 2 else None
                # pick the oldest non-clean-latest, non-pinned buffer as
                # dirty; with one persist in flight at least one candidate
                # always exists (NBUF=3), but queued-up persists may pin
                # more — then wait for a pin release, never overwrite
                latest = int(ctl[1])
                with pin_cond:
                    while True:
                        cands = [(int(ctl[2 + 2 * i]), i)
                                 for i in range(NBUF)
                                 if i != latest and i not in pinned]
                        if cands:
                            break
                        pin_cond.wait(0.1)
                dirty = min(cands)[1]
                if trace:
                    why = ServerValidator.on_begin_select(
                        dirty, latest, pinned)
                    if why:
                        _send(("protocol-error", why))
                ctl[2 + 2 * dirty] = step
                ctl[3 + 2 * dirty] = ST_DIRTY
                if base_step is not None:
                    # delta flight: seed the new shard from the base
                    # (latest clean) buffer so unchanged bytes — own AND
                    # parity — carry over; only the delta buckets will be
                    # rewritten.  Copying (not writing the clean buffer in
                    # place) preserves the 3-buffer rotation invariant: an
                    # aborted delta never damages the published base.  A
                    # base miss is acked False — the trainer aborts the
                    # flight and takes a keyframe instead.
                    ok = (latest >= 0
                          and int(ctl[3 + 2 * latest]) == ST_CLEAN
                          and int(ctl[2 + 2 * latest]) == int(base_step))
                    if ok:
                        buf_np[dirty][:] = buf_np[latest]
                    _send(("base", step, bool(ok)))
                elif lay.parity_bytes:
                    buf_np[dirty][lay.own_bytes:] = 0
            elif op == "bucket":
                _, slot, kind, dst, nb = msg
                src = stage_np[slot, :nb]
                if kind == 0:                      # own data block bytes
                    buf_np[dirty][dst:dst + nb] = src
                elif kind == 2:                    # device-encoded parity:
                    buf_np[dirty][lay.own_bytes + dst:     # plain write, no
                                  lay.own_bytes + dst + nb] = src  # host XOR
                else:                              # parity-stripe bytes: XOR
                    dview = buf_np[dirty][lay.own_bytes + dst:
                                          lay.own_bytes + dst + nb]
                    np.bitwise_xor(dview, src, out=dview)
                sem.release()
            elif op == "end":
                _, step, meta_blob = msg[:3]
                want_crc = bool(msg[3]) if len(msg) > 3 else False
                crc_own = msg[4] if len(msg) > 4 else None
                crc_stripes = msg[5] if len(msg) > 5 else None
                if (crc_own is not None or want_crc or lay.parity_bytes
                        or crc_stripes):
                    meta = pickle.loads(meta_blob)
                    seg = lay.bs if lay.n > 1 else lay.own_bytes
                    if crc_own is not None:
                        # device encode path: the CRC was computed bucket-
                        # wise on the accelerator and combined on the
                        # trainer side — the SMP's own-region zlib pass
                        # drops to a meta rewrite (the per-stripe table
                        # arrives precombined the same way)
                        meta["crc_own"] = int(crc_own) & 0xFFFFFFFF
                        if crc_stripes:
                            meta["crc_stripes"] = {
                                "seg": seg,
                                "crcs": [int(c) & 0xFFFFFFFF
                                         for c in crc_stripes]}
                    elif want_crc:
                        # HASC L3: digests are computed here, inside the
                        # SMP, off every trainer-side critical path — one
                        # pass, segmented per RAIM5 block ("stripe"), so
                        # PARTIAL restore plans can verify only the
                        # stripes they read; the whole-region crc_own the
                        # loader's folded full-plan check recomputes is
                        # derived from the segments by GF(2) combine.
                        crcs = [zlib.crc32(buf_np[dirty][a:a + seg])
                                for a in range(0, lay.own_bytes, seg)]
                        meta["crc_stripes"] = {"seg": seg, "crcs": crcs}
                        meta["crc_own"] = crc32_concat(
                            (c, min(seg, lay.own_bytes - a))
                            for c, a in zip(crcs,
                                            range(0, lay.own_bytes, seg)))
                    if lay.parity_bytes:
                        # parity carries no digest in the bucket stream;
                        # checksum it at publish (still off the trainer's
                        # path) so restore can verify decode inputs —
                        # a corrupt survivor parity block would otherwise
                        # XOR silently into reconstructed bytes
                        meta["crc_parity"] = zlib.crc32(
                            buf_np[dirty][lay.own_bytes:])
                    meta_blob = pickle.dumps(meta)
                base = dirty * META_SLOT
                mb = memoryview(meta_shm.buf)
                mb[base:base + 8] = struct.pack("<q", len(meta_blob))
                mb[base + 8:base + 8 + len(meta_blob)] = meta_blob
                ctl[2 + 2 * dirty] = step
                ctl[3 + 2 * dirty] = ST_CLEAN
                ctl[1] = dirty                     # atomic-enough publish
                dirty = -1
                _send(("clean", step))
            elif op == "persist":
                # select + pin the buffer synchronously (no begin/end can
                # interleave), then hand the write to the worker — the
                # loop goes straight back to draining buckets while the
                # shard streams to disk
                _, seq, path, want_step, delay_s = msg[:5]
                opts = msg[5] if len(msg) > 5 else None
                latest = int(ctl[1])
                err = None
                if latest < 0:
                    err = "no clean snapshot to persist"
                idx = latest
                if err is None and want_step is not None:
                    # SG-consistent checkpoint: every member persists the
                    # SAME step
                    for i in range(NBUF):
                        if (int(ctl[3 + 2 * i]) == ST_CLEAN
                                and int(ctl[2 + 2 * i]) == want_step):
                            idx = i
                            break
                    else:
                        err = (f"step {want_step} no longer clean on "
                               f"node {node}")
                if err is not None:
                    _send(("persist-error", seq, err))
                else:
                    with pin_cond:
                        pinned[idx] = pinned.get(idx, 0) + 1
                    persist_q.put((seq, path, idx, int(ctl[2 + 2 * idx]),
                                   delay_s, opts))
            elif op == "ping":
                _send(("pong", time.time()))
            elif op == "stop":
                break
    except (EOFError, KeyboardInterrupt):
        # Training side vanished (software failure). The paper's SMP keeps
        # the clean snapshot alive; a reconnect signal is not possible over
        # a broken pipe, so park on a never-set event (interruptible, no
        # polling) holding the segments until killed.
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            pass
    finally:
        # drain queued persists before dropping the segments (a durable
        # write already accepted must not be torn by a clean stop)
        persist_q.put(None)
        worker.join(timeout=60)
        import gc
        del stage_np, buf_np, ctl
        gc.collect()
        for s in [stage, ctl_shm, meta_shm] + bufs:
            try:
                s.close()
            except Exception:
                pass


def _tmp_name(path: str, tag) -> str:
    """Unique scratch name per (process, persist seq): two persists
    targeting the same path — or a new persist racing a dead SMP's
    leftover — can never collide on one `.tmp`."""
    return f"{path}.{os.getpid()}.{tag}.tmp"


class _TokenBucket:
    """Byte-rate limiter for the SMP's background writes (the
    `persist_bw_limit` knob).  Charged per chunk/part BEFORE the write;
    when the bucket runs dry the persist worker sleeps until the deficit
    refills — trainer-side snapshots never block (the buffer is pinned,
    `begin` just picks another).  Burst is a quarter second of rate so
    small shards pass untouched.

    The restore side shares this class (`restore_bw_limit` via
    `readsched.BucketedSource`); pass `threadsafe=True` there — many
    reader threads charge one bucket, so the token arithmetic runs under
    a lock while the deficit sleep stays outside it."""

    def __init__(self, rate_bytes_s: float, threadsafe: bool = False):
        self.rate = float(rate_bytes_s)
        self.burst = max(self.rate * 0.25, float(1 << 20))
        self.tokens = self.burst
        self.t_last = time.perf_counter()
        self.throttled_s = 0.0
        self._lock = named_lock("smp.tokenbucket") if threadsafe else None

    def _tick(self, nbytes: int) -> float:
        now = time.perf_counter()
        self.tokens = min(self.burst,
                          self.tokens + (now - self.t_last) * self.rate)
        self.t_last = now
        self.tokens -= nbytes
        if self.tokens < 0:
            wait = -self.tokens / self.rate
            self.throttled_s += wait
            return wait
        return 0.0

    def consume(self, nbytes: int) -> None:
        if self._lock is None:
            wait = self._tick(nbytes)
        else:
            with self._lock:
                wait = self._tick(nbytes)
        if wait > 0:
            time.sleep(wait)


def _stream_write(f, arr: np.ndarray,
                  chunk_bytes: int = PERSIST_CHUNK_BYTES,
                  throttle=None) -> int:
    """Write `arr` (a uint8 view over the snapshot buffer) in fixed
    chunks.  The old `arr.tobytes()` materialized a full second copy of
    the shard — doubling RSS exactly while a snapshot may be staging."""
    nb = arr.nbytes
    for off in range(0, nb, chunk_bytes):
        chunk = memoryview(arr[off:off + chunk_bytes])
        if throttle is not None:
            throttle(chunk.nbytes)
        f.write(chunk)
    return nb


def _head_and_meta(node, lay, idx, step, meta_shm):
    """Build the shard head blob for buffer `idx` plus the digest record
    the remote manifest wants.  One head serves both durable paths: the
    local `.reft` file is `head_blob + buffer`, and the uploaded shard
    object is byte-identical, so the loader's parse/verify code reads
    either through one format."""
    base = idx * META_SLOT
    mlen = struct.unpack("<q", bytes(meta_shm.buf[base:base + 8]))[0]
    meta = bytes(meta_shm.buf[base + 8:base + 8 + mlen])
    digests = {"crc_stripes": None, "crc_own": None, "crc_parity": None}
    try:                      # surface the digest table in the file head
        md = pickle.loads(meta)
        for k in digests:
            digests[k] = md.get(k)
    except Exception:
        pass
    head = {"node": node, "n": lay.n, "total_bytes": lay.total_bytes,
            "step": step, "meta": meta,
            "crc_stripes": digests["crc_stripes"]}
    return pickle.dumps(head), digests


def _persist_delta_buffer(path, buf, extents, tag, head_blob,
                          throttle=None):
    """Stream a `.reftd` delta shard atomically: head blob (which
    records `base_step` + `extents`) followed by the raw bytes of each
    buffer-local extent, concatenated in order."""
    tmp = _tmp_name(path, tag)
    try:
        with open(tmp, "wb") as f:
            if throttle is not None:
                throttle(len(head_blob))
            f.write(head_blob)
            for lo, hi in extents:
                _stream_write(f, buf[lo:hi], throttle=throttle)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        try:
            os.unlink(tmp)                 # no-op after a clean replace
        except FileNotFoundError:
            pass


def _persist_buffer(path, node, lay, idx, step, buf_np, meta_shm, tag,
                    head_blob=None, throttle=None):
    """Stream buffer `idx` (already persist-pinned by the caller) to
    `path` atomically.  The scratch file is unlinked on ANY failure —
    write or fsync errors no longer leak `.tmp` files into the family
    directory."""
    if head_blob is None:
        head_blob, _ = _head_and_meta(node, lay, idx, step, meta_shm)
    tmp = _tmp_name(path, tag)
    try:
        with open(tmp, "wb") as f:
            if throttle is not None:
                throttle(len(head_blob))
            f.write(head_blob)
            _stream_write(f, buf_np[idx], throttle=throttle)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        try:
            os.unlink(tmp)                 # no-op after a clean replace
        except FileNotFoundError:
            pass


# ---------------------------------------------------------------- handles
class SMPHandle:
    """Trainer-side handle to one node's SMP."""

    def __init__(self, run: str, node: int, n: int, total_bytes: int, *,
                 stage_slots: int = 8, bucket_bytes: int = 4 << 20,
                 pin_cpus=None, trace: bool = False):
        self.run, self.node, self.n = run, node, n
        # runtime protocol monitor (ReftConfig.trace_protocol): every
        # sent/received message is validated against the FLIGHT_FSM
        # table - a desync raises ProtocolViolation instead of wedging
        self._validator = (TraceValidator(f"smp-n{node}") if trace
                           else None)
        self._stopped = False
        self.layout = NodeLayout(n, total_bytes)
        self.stage_slots = stage_slots
        self.bucket_bytes = bucket_bytes
        self._sem = _MP.BoundedSemaphore(stage_slots)
        self._conn, child = _MP.Pipe()
        self.proc = _MP.Process(
            target=_smp_main,
            args=(child, run, node, n, total_bytes, stage_slots,
                  bucket_bytes, self._sem, tuple(pin_cpus) if pin_cpus
                  else None, trace),
            daemon=True, name=f"smp-{run}-n{node}")
        self.proc.start()
        child.close()
        self._stage = None
        self._slot = 0
        # Demultiplexed pipe protocol: persists complete asynchronously in
        # the SMP, so ("persisted"/"persist-error", seq, ...) replies can
        # interleave with ("clean", ...) and ("pong", ...) at any time.
        # Every receive routes messages to per-kind queues under one lock
        # (`_await`); sends take `_tx_lock` (the stager thread and an
        # async persist may hit the pipe concurrently).
        self._tx_lock = named_lock("smp.handle.tx")
        self._rx_lock = named_lock("smp.handle.rx")
        self._rx_clean: deque = deque()
        self._rx_pong: deque = deque()
        self._rx_base: deque = deque()
        self._rx_persist: Dict[int, tuple] = {}
        self._stale_persists: set = set()      # timed-out seqs: drop late
        self._pending_persists: List[int] = []  # fire order
        self._persist_seq = 0
        self._wait_ready()

    def _wait_ready(self, timeout=90.0):
        """Event-driven come-up: block on the SMP's `ready` message (sent
        after every segment is created and sized) instead of sleep-polling
        shm_open.  After `ready`, attach cannot race the SMP.  The budget
        is a liveness bound only — spawn + numpy import for several SMPs
        can take tens of seconds on a CPU-throttled host."""
        if not self._conn.poll(timeout):
            raise TimeoutError("SMP did not come up")
        try:
            msg = self._conn.recv()
        except EOFError:
            # child died before sending ready (e.g. shm creation failed);
            # keep the historical, diagnosable come-up error
            raise TimeoutError(
                f"SMP for node {self.node} died during startup") from None
        if msg[0] != "ready":
            raise RuntimeError(f"unexpected SMP hello {msg!r}")
        if self._validator is not None:
            self._validator.rx(msg)
        self._stage = _attach(_seg(self.run, self.node, "stage"))
        self._stage_np = np.ndarray(
            (self.stage_slots, self.bucket_bytes), np.uint8,
            self._stage.buf)

    # -- demultiplexed receive ---------------------------------------------
    def _dispatch(self, msg) -> None:
        """Route one SMP message to its queue (callers hold _rx_lock)."""
        tag = msg[0]
        if self._validator is not None:
            self._validator.rx(msg)       # raises on desync
        if tag == "protocol-error":
            # an SMP-side invariant check tripped (tracing off: never sent)
            raise ProtocolViolation(f"SMP node {self.node}: {msg[1]}")
        if tag == "clean":
            self._rx_clean.append(msg)
        elif tag == "pong":
            self._rx_pong.append(msg)
        elif tag == "base":
            self._rx_base.append(msg)
        elif tag in ("persisted", "persist-error"):
            seq = msg[1]
            if seq in self._stale_persists:
                # late reply of a timed-out persist: discard instead of
                # letting the next clean/pong recv consume it (the
                # protocol-desync bug this demux exists to fix)
                self._stale_persists.discard(seq)
                return
            self._rx_persist[seq] = msg
        # unknown tags are dropped defensively

    def _await(self, have, timeout: float, what: str):
        """Poll/recv under the rx lock, dispatching every message to its
        queue, until `have()` yields a value or `timeout` passes.  Any
        thread may be the reader; messages meant for other waiters are
        queued for them, never consumed by the wrong protocol exchange."""
        deadline = time.monotonic() + timeout
        while True:
            with self._rx_lock:
                got = have()
                if got is not None:
                    return got
                if self._conn.poll(0.05):
                    # demux by design: the rx lock IS the single-reader
                    # guarantee; recv follows a ready poll (bounded hold)
                    # analyze: ok ANZ002
                    self._dispatch(self._conn.recv())
                    continue
            if time.monotonic() >= deadline:
                raise TimeoutError(what)

    def _drain_rx(self) -> None:
        """Non-blocking: route everything currently in the pipe."""
        with self._rx_lock:
            while self._conn.poll(0):
                # analyze: ok ANZ002 — poll(0) guarantees a ready frame
                self._dispatch(self._conn.recv())

    def _send(self, msg) -> None:
        with self._tx_lock:
            if self._validator is not None:
                self._validator.tx(msg)   # raises on an off-table send
            self._conn.send(msg)

    # -- snapshot protocol -------------------------------------------------
    def begin(self, step: int, base_step: Optional[int] = None) -> bool:
        """Open a snapshot flight.  With `base_step`, open a *delta*
        flight: the SMP seeds the dirty buffer from the clean shard of
        `base_step` and acks whether that base is still its latest clean
        step — False means the caller must abort and take a keyframe."""
        if base_step is None:
            self._send(("begin", int(step)))
            return True
        self._send(("begin", int(step), int(base_step)))
        msg = self._await(
            lambda: self._rx_base.popleft() if self._rx_base else None,
            60.0, "SMP delta-begin ack timeout")
        return bool(msg[2])

    def send_bucket(self, kind: int, dst: int, payload: np.ndarray):
        # ring-slot credit: the cross-process BoundedSemaphore the SMP
        # releases per consumed bucket — the L2 stager blocks here (no
        # busy-wait) when the staging ring is full, which is exactly the
        # backpressure that stalls L1 through the scratch-credit queue.
        # A dead SMP can never release a credit, so poll liveness instead
        # of blocking forever: the raise routes the engine to degraded.
        while not self._sem.acquire(timeout=0.5):
            if not self.proc.is_alive():
                raise BrokenPipeError(
                    f"SMP for node {self.node} died mid-snapshot "
                    f"(ring credits lost)")
        slot = self._slot
        self._slot = (self._slot + 1) % self.stage_slots
        nb = payload.nbytes
        # local ref: kill()/release() nulls _stage_np concurrently with an
        # in-flight send; a closed handle must read as "SMP gone" (degrade),
        # not TypeError (fatal)
        stage = self._stage_np
        if stage is None:
            raise BrokenPipeError(
                f"SMP handle for node {self.node} closed mid-snapshot")
        stage[slot, :nb] = payload.reshape(-1).view(np.uint8)
        self._send(("bucket", slot, kind, int(dst), nb))

    def end(self, step: int, meta_blob: bytes, want_crc: bool = False,
            crc_own: Optional[int] = None,
            crc_stripes: Optional[List[int]] = None) -> None:
        """`want_crc=True` asks the SMP to compute the own-region digests
        (whole-region + per-stripe table) into the snapshot meta at
        publish time (off the trainer's hot path); `crc_own`/`crc_stripes`
        hand over precomputed digests (device encode path) so the SMP
        skips its zlib pass entirely."""
        self._send(("end", int(step), meta_blob, bool(want_crc),
                    None if crc_own is None else int(crc_own),
                    None if crc_stripes is None else
                    [int(c) for c in crc_stripes]))

    def wait_clean(self, timeout=60.0) -> int:
        msg = self._await(
            lambda: self._rx_clean.popleft() if self._rx_clean else None,
            timeout, "SMP ack timeout")
        return msg[1]

    def ping(self, timeout=10.0) -> float:
        self._send(("ping",))
        msg = self._await(
            lambda: self._rx_pong.popleft() if self._rx_pong else None,
            timeout, "SMP ping timeout")
        return msg[1]

    # -- REFT-Ckpt persist protocol ----------------------------------------
    def persist_send(self, path: str, step: Optional[int] = None,
                     delay_s: float = 0.0, opts: Optional[dict] = None
                     ) -> int:
        """Fire a persist request; returns its sequence id (the ticket
        `persist_wait`/`persist_poll` take).  The SMP services it on a
        background thread, so snapshots keep flowing while the shard
        streams to disk.  `delay_s` simulates a slow durable tier (tests
        and the interference benchmark).  `opts` is a plain picklable
        dict of worker knobs: `bw_limit` (token-bucket bytes/s for the
        write stream) and `remote` (`{store, key, retry}` — mirror the
        shard to an object store after the local write)."""
        with self._rx_lock:
            self._persist_seq += 1
            seq = self._persist_seq
            self._pending_persists.append(seq)
        self._send(("persist", seq, path, step,
                    float(delay_s) if delay_s else 0.0, opts))
        return seq

    def _take_persist(self, seq: int):
        msg = self._rx_persist.pop(seq, None)
        if msg is not None and seq in self._pending_persists:
            self._pending_persists.remove(seq)
        return msg

    def persist_result(self, seq: Optional[int] = None,
                       timeout: float = 120.0) -> tuple:
        """Blocking: the raw ("persisted", seq, path, step) or
        ("persist-error", seq, err) reply for `seq` (default: the oldest
        outstanding).  On timeout the seq is marked stale, so its late
        reply is discarded instead of desyncing the next clean/pong
        exchange."""
        if seq is None:
            with self._rx_lock:
                if not self._pending_persists:
                    raise RuntimeError("no persist in flight")
                seq = self._pending_persists[0]
        try:
            return self._await(lambda: self._take_persist(seq),
                               timeout, "persist timeout")
        except TimeoutError:
            with self._rx_lock:
                msg = self._take_persist(seq)   # landed since last check?
                if msg is None:
                    self._stale_persists.add(seq)
                    if self._validator is not None:
                        self._validator.mark_stale(seq)
                    if seq in self._pending_persists:
                        self._pending_persists.remove(seq)
                    raise
            return msg

    def persist_wait(self, seq: Optional[int] = None,
                     timeout: float = 120.0) -> str:
        msg = self.persist_result(seq, timeout)
        if msg[0] == "persist-error":
            raise RuntimeError(f"SMP persist failed: {msg[2]}")
        return msg[2]

    def persist_poll(self, seq: int) -> Optional[tuple]:
        """Non-blocking: the reply for `seq` if it has arrived (draining
        the pipe on the way), else None."""
        with self._rx_lock:
            while self._conn.poll(0):
                # analyze: ok ANZ002 — poll(0) guarantees a ready frame
                self._dispatch(self._conn.recv())
            return self._take_persist(seq)

    def persist(self, path: str, timeout=120.0, step: Optional[int] = None
                ) -> str:
        seq = self.persist_send(path, step)
        return self.persist_wait(seq, timeout)

    def alive(self) -> bool:
        return self.proc.is_alive()

    def stop(self):
        """Clean shutdown.  Idempotent: a second stop() (or close()) is a
        no-op — engine teardown, supervisor heal and user-level close()
        may all race onto the same handle.  Safe mid-persist: the SMP
        drains its persist queue before dropping the segments, so an
        accepted durable write still lands; its late reply is simply
        never read."""
        if self._stopped:
            return
        self._stopped = True
        try:
            self._send(("stop",))
        except (BrokenPipeError, OSError):
            pass
        self.proc.join(timeout=5)
        if self.proc.is_alive():
            self.proc.kill()
        self._stage_np = None
        import gc
        gc.collect()
        if self._stage is not None:
            self._stage.close()
            self._stage = None
        ReadOnlyNode.unlink_node(self.run, self.node)

    def close(self):
        """Alias for stop() (idempotent clean shutdown)."""
        self.stop()

    def kill(self):
        """Simulate an SMP software crash (segments survive).  A later
        stop() is still allowed (it reaps the proc and unlinks segments),
        so kill() does NOT mark the handle stopped."""
        self.proc.kill()
        self.proc.join()
        self.release()

    def release(self):
        """Drop this handle's shm mappings (no unlink, no proc changes)."""
        self._stage_np = None
        import gc
        gc.collect()
        if self._stage is not None:
            try:
                self._stage.close()
            except BufferError:
                pass
            self._stage = None


class ReadOnlyNode:
    """Recovery-side view of a node's SMP segments (attach by name)."""

    def __init__(self, run: str, node: int, n: int, total_bytes: int):
        self.run, self.node = run, node
        self.layout = NodeLayout(n, total_bytes)
        self._ctl_shm = _attach(_seg(run, node, "ctl"))
        if self._ctl(0) != MAGIC:
            self._ctl_shm.close()
            raise RuntimeError("bad ctl magic")
        self._bufs = [_attach(_seg(run, node, f"buf{i}")) for i in range(NBUF)]
        self._meta = _attach(_seg(run, node, "meta"))

    def _ctl(self, i: int) -> int:
        """Read one ctl slot without keeping exported pointers alive."""
        return struct.unpack_from("<q", self._ctl_shm.buf, i * 8)[0]

    def clean_steps(self) -> dict:
        """{step: buf_idx} of all CLEAN buffers."""
        out = {}
        for i in range(NBUF):
            if self._ctl(3 + 2 * i) == ST_CLEAN:
                out[self._ctl(2 + 2 * i)] = i
        return out

    def latest_clean(self) -> Optional[int]:
        idx = self._ctl(1)
        return None if idx < 0 else self._ctl(2 + 2 * idx)

    def _buf(self, step: int) -> np.ndarray:
        # copy: callers keep results after close(), and the segment may be
        # unlinked under us (simulated node failure)
        return self.read_range(step, 0, self.layout.buf_bytes)

    def meta(self, step: int) -> bytes:
        idx = self.clean_steps()[step]
        base = idx * META_SLOT
        mlen = struct.unpack("<q", bytes(self._meta.buf[base:base + 8]))[0]
        return bytes(self._meta.buf[base + 8:base + 8 + mlen])

    # ------------------------------------------------ scatter-gather reads
    def read_range(self, step: int, lo: int, hi: int) -> np.ndarray:
        """Copy ONLY bytes [lo, hi) of the step's snapshot buffer (local
        own+parity coordinates) — the ranged primitive the distributed
        loader's `LoadPlan` executors use instead of whole-region copies."""
        idx = self.clean_steps()[step]
        shm = self._bufs[idx]
        view = np.ndarray((self.layout.buf_bytes,), np.uint8, shm.buf)
        out = view[lo:hi].copy()
        del view                     # no exported pointers past this call
        return out

    def read_ranges(self, step: int, ranges) -> list:
        """Scatter-gather: one buffer lookup, many range copies.
        `ranges` is a sequence of local (lo, hi) pairs."""
        idx = self.clean_steps()[step]
        shm = self._bufs[idx]
        view = np.ndarray((self.layout.buf_bytes,), np.uint8, shm.buf)
        out = [view[lo:hi].copy() for lo, hi in ranges]
        del view
        return out

    def read_own(self, step: int) -> np.ndarray:
        return self.read_range(step, 0, self.layout.own_bytes)

    def _block_local(self, stripe: int, index: int) -> int:
        return raim5.local_block_index(self.node, stripe, index,
                                       self.layout.n)

    def read_block(self, step: int, stripe: int, index: int) -> np.ndarray:
        """One of this node's data blocks, addressed by (stripe, index)."""
        lay = self.layout
        local = self._block_local(stripe, index)
        return self.read_range(step, local * lay.bs, (local + 1) * lay.bs)

    def read_block_range(self, step: int, stripe: int, index: int,
                         o1: int, o2: int) -> np.ndarray:
        """Bytes [o1, o2) *within* data block (stripe, index) — the
        range-limited RAIM5 decode primitive."""
        base = self._block_local(stripe, index) * self.layout.bs
        return self.read_range(step, base + o1, base + o2)

    def read_parity(self, step: int) -> np.ndarray:
        lay = self.layout
        return self.read_range(step, lay.own_bytes,
                               lay.own_bytes + lay.parity_bytes)

    def read_parity_range(self, step: int, o1: int, o2: int) -> np.ndarray:
        base = self.layout.own_bytes
        return self.read_range(step, base + o1, base + o2)

    def close(self):
        for s in [self._ctl_shm, self._meta] + self._bufs:
            try:
                s.close()
            except Exception:
                pass

    @staticmethod
    def unlink_node(run: str, node: int):
        """Simulated node failure / final cleanup: drop all segments."""
        for what in (["stage", "ctl", "meta"] +
                     [f"buf{i}" for i in range(NBUF)]):
            try:
                s = _Shm(name=_seg(run, node, what), track=False)
                s.close()
                s.unlink()
            except FileNotFoundError:
                pass
