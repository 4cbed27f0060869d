"""Disk checkpointing backends (paper §6.1 baselines, unified API).

Low-level machinery (one on-disk format, phase-timed):
  * `DiskWriter` — d2h copy + byte-stream framing + (optionally sharded,
    parallel) file I/O, run synchronously or overlapped on a thread.
  * `load_checkpoint` / `latest_complete_step` — reassembly + discovery.

Facade backends registered here:
  * `sync_disk`  — blocking full-state save each snapshot() (the classic
    torch.save-style baseline; worst overhead, simplest semantics).
  * `async_disk` — overlapped save (CheckFreq-style unsharded by default;
    `options={"shard": True}` gives the TorchSnapshot-style 1/m-per-rank
    variant with parallel I/O).

The legacy class names (`CheckFreqCheckpointer`, `TorchSnapshotCheckpointer`)
survive as thin aliases in `repro_torch.ckpt`.
"""
from __future__ import annotations

import os
import pickle
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.api.registry import register_backend
from repro_torch.api.types import Checkpointer, CheckpointSpec, RestoreResult
from repro_torch.core.recovery import RecoveryError
from repro_torch.core.snapshot import _LeafReader
from repro_torch.core.treebytes import (
    FlatSpec, buffer_to_tree, leaf_arrays, make_flat_spec,
)


@dataclass
class PhaseTimes:
    d2h: float = 0.0
    serialize: float = 0.0
    persist: float = 0.0
    total: float = 0.0


class DiskWriter:
    """Common save machinery; `shard=False` -> CheckFreq, True ->
    TorchSnapshot (state split along DP paths, parallel per-rank I/O)."""

    name = "disk"

    def __init__(self, out_dir: str, state_template: Any, *,
                 n_ranks: int = 1, shard: bool = False,
                 bucket_bytes: int = 16 << 20, fsync: bool = False):
        self.dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.spec = make_flat_spec(state_template)
        self.n_ranks = n_ranks
        self.shard = shard
        self.bucket_bytes = bucket_bytes
        self.fsync = fsync
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self.last_times = PhaseTimes()
        self.last_step = -1

    # ------------------------------------------------------------ ranges
    def _rank_range(self, rank: int) -> Tuple[int, int]:
        total = self.spec.total_bytes
        if not self.shard:
            return 0, total
        per = -(-total // self.n_ranks)
        return min(rank * per, total), min((rank + 1) * per, total)

    # -------------------------------------------------------------- save
    def save_async(self, state: Any, step: int,
                   extra_meta: dict = None) -> bool:
        if self._thread is not None and self._thread.is_alive():
            return False                      # previous ckpt still in flight
        self._raise_pending()
        leaves = leaf_arrays(state)
        self._thread = threading.Thread(
            target=self._run, args=(leaves, int(step), extra_meta or {}),
            daemon=True)
        self._thread.start()
        return True

    def save_sync(self, state: Any, step: int,
                  extra_meta: dict = None) -> PhaseTimes:
        assert self.save_async(state, step, extra_meta)
        self.wait()
        return self.last_times

    def wait(self, timeout: float = 600.0):
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self._raise_pending()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def _run(self, leaves, step, extra_meta):
        try:
            t_all = time.time()
            times = PhaseTimes()
            # phase 1: d2h ("snapshotting") of every rank's range
            t0 = time.time()
            reader = _LeafReader(self.spec, leaves)
            bufs: Dict[int, np.ndarray] = {}
            for r in range(self.n_ranks):
                lo, hi = self._rank_range(r)
                buf = np.empty(hi - lo, np.uint8)
                reader.read(lo, hi, buf)
                bufs[r] = buf
                if not self.shard:
                    break                      # every rank copies the same
            times.d2h = time.time() - t0

            # phase 2: serialization (byte-stream framing, paper step 2)
            t0 = time.time()
            blobs: Dict[int, bytes] = {}
            for r, buf in bufs.items():
                lo, hi = self._rank_range(r)
                head = {"step": step, "rank": r, "lo": lo, "hi": hi,
                        "n_ranks": self.n_ranks if self.shard else 1,
                        "spec": self.spec.to_json(), "extra": extra_meta}
                blobs[r] = pickle.dumps(head) + buf.tobytes()
            times.serialize = time.time() - t0

            # phase 3: persist (parallel I/O for the sharded variant)
            t0 = time.time()
            threads = []
            for r, blob in blobs.items():
                th = threading.Thread(target=self._write, args=(step, r, blob))
                th.start()
                threads.append(th)
            for th in threads:
                th.join()
            times.persist = time.time() - t0
            times.total = time.time() - t_all
            self.last_times = times
            self.last_step = step
        except BaseException as e:
            self._err = e

    def _write(self, step, rank, blob):
        path = os.path.join(self.dir, f"ckpt-{step}-r{rank}.bin")
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
                if self.fsync:
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            try:
                os.unlink(tmp)             # no-op after a clean replace
            except FileNotFoundError:
                pass


# ------------------------------------------------------------------ load
def _shard_files(out_dir: str, step: int) -> list:
    return sorted(f for f in os.listdir(out_dir)
                  if f.startswith(f"ckpt-{step}-r") and f.endswith(".bin"))


def latest_complete_step(out_dir: str) -> Optional[int]:
    """Newest step whose shard family is fully on disk."""
    steps: Dict[int, int] = {}
    try:
        names = os.listdir(out_dir)
    except FileNotFoundError:
        return None
    for fn in names:
        if fn.startswith("ckpt-") and fn.endswith(".bin"):
            try:
                steps[int(fn.split("-")[1])] = steps.get(
                    int(fn.split("-")[1]), 0) + 1
            except ValueError:
                continue
    for step in sorted(steps, reverse=True):
        fn = _shard_files(out_dir, step)[0]
        with open(os.path.join(out_dir, fn), "rb") as f:
            head = pickle.load(f)
        if steps[step] >= head["n_ranks"]:
            return step
    return None


def load_checkpoint(out_dir: str, step: int, template: Any,
                    with_meta: bool = False):
    """Reassemble a checkpoint written by any disk backend."""
    files = _shard_files(out_dir, step)
    if not files:
        raise FileNotFoundError(f"no checkpoint for step {step} in {out_dir}")
    buf = None
    spec = None
    extra: dict = {}
    for fn in files:
        with open(os.path.join(out_dir, fn), "rb") as f:
            head = pickle.load(f)
            payload = np.frombuffer(f.read(), np.uint8)
        spec = FlatSpec.from_json(head["spec"])
        extra = head.get("extra", {})
        if buf is None:
            buf = np.zeros(spec.total_bytes, np.uint8)
        buf[head["lo"]:head["hi"]] = payload[:head["hi"] - head["lo"]]
        if head["n_ranks"] == 1:
            break
    tree = buffer_to_tree(template, spec, buf)
    return (tree, extra) if with_meta else tree


# ----------------------------------------------------------- facade glue
class _DiskCheckpointer(Checkpointer):
    """Checkpointer protocol over `DiskWriter`."""

    def __init__(self, spec: CheckpointSpec, state_template: Any, *,
                 sync: bool):
        super().__init__(spec)
        self.sync = sync
        self.template = state_template
        shard = bool(spec.options.get("shard", False))
        self.writer = DiskWriter(
            spec.ckpt_dir, state_template,
            n_ranks=spec.sg_size if shard else 1, shard=shard,
            bucket_bytes=spec.options.get(
                "io_bucket_bytes", max(spec.bucket_bytes, 16 << 20)),
            fsync=spec.fsync)

    def snapshot(self, state, step, extra_meta=None, wait=False):
        t0 = time.perf_counter()
        if self.sync or wait:
            self.writer.wait()                 # drain any in-flight save
            times = self.writer.save_sync(state, step, extra_meta)
            self.emit("snapshot", step, seconds=times.total,
                      nbytes=self.writer.spec.total_bytes)
            return True
        started = self.writer.save_async(state, step, extra_meta)
        if started:
            self.emit("snapshot", step, seconds=time.perf_counter() - t0,
                      nbytes=self.writer.spec.total_bytes,
                      detail="async-launch")
        return started

    def persist(self, step=None, wait=True):
        """Disk saves are already durable once the writer finishes; the
        drain IS the durability barrier, so `wait` is accepted for
        protocol parity and ignored (the types.py contract for
        inherently synchronous persists) — `async_disk`'s overlap is the
        save itself, and skipping the drain would return un-durable
        steps as tickets no poll ever completes."""
        t0 = time.perf_counter()
        self.writer.wait()
        last = self.writer.last_step
        if last >= 0:
            self.emit("persist", last, seconds=time.perf_counter() - t0)
            self._gc(keep_from=last)
        return last if last >= 0 else None

    def _gc(self, keep_from: int):
        """Keep-latest-k over COMPLETE families; torn families (a crash
        mid-save) are garbage outright — _gc only runs after wait(), so
        nothing here can be in flight.  Counting torn families toward
        `keep` would let every crash evict a restorable checkpoint."""
        from repro_torch.ckpt.manager import plan_gc
        keep = self.spec.keep
        if not keep:
            return
        expect = self.writer.n_ranks if self.writer.shard else 1
        families: Dict[int, list] = {}
        for fn in os.listdir(self.writer.dir):
            if fn.startswith("ckpt-") and fn.endswith(".bin"):
                families.setdefault(int(fn.split("-")[1]), []).append(fn)
        complete = {s for s, fns in families.items() if len(fns) >= expect}
        kept = set(sorted(complete)[-keep:])
        removed = 0
        for s in plan_gc(families, complete, kept):
            for fn in families[s]:
                try:
                    os.remove(os.path.join(self.writer.dir, fn))
                    removed += 1
                except FileNotFoundError:
                    pass
        if removed:
            self.emit("gc", keep_from, detail=f"removed {removed} shards")

    def restore(self, step=None, target=None):
        from repro_torch.core.loader import LoadStats
        t0 = time.perf_counter()
        self.writer.wait()
        step = latest_complete_step(self.writer.dir) if step is None else step
        if step is None:
            raise RecoveryError(f"no disk checkpoint in {self.writer.dir}")
        state, extra = load_checkpoint(self.writer.dir, step, self.template,
                                       with_meta=True)
        # disk baselines read shard files whole (that inefficiency is the
        # paper's point of comparison) — report honest monolithic stats
        st = LoadStats(tier="disk", source="file",
                       bytes_read=self.writer.spec.total_bytes,
                       bytes_needed=self.writer.spec.total_bytes,
                       read_seconds=time.perf_counter() - t0)
        st.wall_seconds = st.read_seconds
        self.emit("restore", step, seconds=time.perf_counter() - t0,
                  tier="disk")
        return RestoreResult(state=state, step=step, extra_meta=extra,
                             tier="disk", load=st)

    def health(self):
        inflight = (self.writer._thread is not None
                    and self.writer._thread.is_alive())
        return {"healthy": True, "degraded": [],
                "members": {"inflight": inflight,
                            "last_step": self.writer.last_step}}

    def wait(self):
        self.writer.wait()

    def close(self):
        try:
            self.writer.wait(timeout=30)
        except BaseException:
            pass


@register_backend("sync_disk")
def _make_sync(spec: CheckpointSpec, template: Any) -> Checkpointer:
    ck = _DiskCheckpointer(spec, template, sync=True)
    ck.name = "sync_disk"
    return ck


@register_backend("async_disk")
def _make_async(spec: CheckpointSpec, template: Any) -> Checkpointer:
    ck = _DiskCheckpointer(spec, template, sync=False)
    ck.name = "async_disk"
    return ck
