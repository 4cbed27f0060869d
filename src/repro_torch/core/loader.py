"""Distributed in-memory checkpoint loading (paper §4.2 "Loading").

The seed-era restore path reassembled the ENTIRE state into one
contiguous host buffer on a single caller, decoded a failed member's
whole shard even when only a few stripes were needed, and read tier-3
`.reft` files whole.  This module replaces all of that with a planned,
ranged, parallel loader:

  LoadPlan      the minimal per-member byte ranges each restoring rank
                actually needs — `FlatSpec` leaf extents intersected with
                a target sharding (elastic `sg_size`, member shard,
                leaf filter, or a `repro_torch.dist` PartitionSpec tree) and
                mapped through the saved RAIM5 block layout;
  sources       scatter-gather range readers over survivor SMP segments
                (`ShmSource` -> `smp.ReadOnlyNode.read_range`) or over
                persisted REFT-Ckpt files (`FileSource`, seek+read — so
                NFS-style disk restores are ranged and per-member-
                parallel too);
  executors     parallel per-member ranged reads, range-limited RAIM5
                decode (`raim5.decode_node_ranges`: a lost member costs
                only the plan-intersecting stripe sub-ranges), incremental
                CRC folded into the read pass (a member's own-region
                digest is verified WHILE its bytes stream, no separate
                probe pass), and streamed per-leaf assembly with
                overlapped `Tensor.to(device)` (h2d of leaf k while leaf
                k+1's ranges are still being read);
  LoadStats     per-phase accounting (`bytes_read`, `decoded_bytes`,
                read/decode/h2d seconds) surfaced through
                `RestoreResult.load`.

Reshard-on-restore: `resolve_need` maps a `RestoreTarget` (different
`sg_size`/mesh than the one that saved — elastic n->m restart) to global
byte ranges via `FlatSpec`, so the plan reads old-layout blocks for
new-layout shards without materialising the full state anywhere.
"""
from __future__ import annotations

import bisect
import pickle
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analyze.lockgraph import named_lock
from repro_torch.core import raim5
from repro_torch.core.treebytes import (FlatSpec, dtype_itemsize, host_bytes,
                                        leaf_arrays, tensor_from_bytes,
                                        tree_unflatten)

CHUNK_BYTES = 8 << 20           # streaming read/CRC granularity
MAX_SLAB_RANGES = 4096          # strided-shard fallback: whole leaf beyond


class CrcMismatch(RuntimeError):
    """A member's own-region bytes do not match its recorded digest (or
    its snapshot meta is unreadable — equally untrustworthy)."""

    def __init__(self, node: int, expect: int = 0, got: int = 0,
                 reason: str = None):
        super().__init__(reason or
                         f"node {node} own-region CRC mismatch "
                         f"(expect {expect:#010x}, got {got:#010x})")
        self.node = node


_META_BAD = object()          # sentinel: meta unreadable -> demote member


# ----------------------------------------------------------------- ranges
def normalize_ranges(ranges: Sequence[Tuple[int, int]], total_bytes: int
                     ) -> Tuple[Tuple[int, int], ...]:
    """Sort, clip to [0, total), drop empties, merge overlaps/adjacency."""
    out: List[Tuple[int, int]] = []
    for lo, hi in sorted((max(0, int(a)), min(int(b), total_bytes))
                         for a, b in ranges):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return tuple(out)


def _intersect(need: Sequence[Tuple[int, int]], lo: int, hi: int
               ) -> List[Tuple[int, int]]:
    """Sub-ranges of sorted disjoint `need` falling inside [lo, hi)."""
    out = []
    i = bisect.bisect_right([a for a, _ in need], lo) - 1
    i = max(i, 0)
    while i < len(need):
        a, b = need[i]
        if a >= hi:
            break
        a2, b2 = max(a, lo), min(b, hi)
        if b2 > a2:
            out.append((a2, b2))
        i += 1
    return out


# ------------------------------------------------------------------- plan
@dataclass(frozen=True)
class RangeReq:
    """One contiguous read from a member's own region (local coords) and
    where its bytes land in the global flat stream."""
    local_lo: int
    local_hi: int
    global_lo: int

    @property
    def nbytes(self) -> int:
        return self.local_hi - self.local_lo


@dataclass(frozen=True)
class LoadPlan:
    """Minimal per-member byte ranges for one restore."""
    n: int                                   # saved SG size (RAIM5 layout)
    total_bytes: int
    need: Tuple[Tuple[int, int], ...]        # normalized global ranges
    reads: Dict[int, Tuple[RangeReq, ...]]   # per surviving member
    decode: Tuple[Tuple[raim5.BlockRef, Tuple[Tuple[int, int], ...]], ...]
    failed: Optional[int]

    @property
    def bytes_needed(self) -> int:
        return sum(b - a for a, b in self.need)

    @property
    def read_bytes(self) -> int:
        """Bytes served by direct survivor reads (excl. decode traffic)."""
        return sum(r.nbytes for reqs in self.reads.values() for r in reqs)

    @property
    def decode_bytes(self) -> int:
        """Failed-member bytes the plan reconstructs from parity."""
        return sum(o2 - o1 for _, subs in self.decode for o1, o2 in subs)

    def member_covered(self, node: int) -> bool:
        """True iff the plan reads every real byte of `node`'s shard —
        the precondition for folding its own-region CRC into the read."""
        real = _member_real_bytes(node, self.n, self.total_bytes)
        return sum(r.nbytes for r in self.reads.get(node, ())) >= real

    @property
    def touched_members(self) -> Tuple[int, ...]:
        """Every member the executor will read bytes from: direct reads
        PLUS the stripe siblings / parity holders feeding the failed
        member's decode — the set a CRC probe must cover."""
        nodes = set(self.reads)
        for ref, _ in self.decode:
            nodes.add(ref.stripe)                       # parity holder
            for j in range(self.n - 1):
                if j != ref.index:
                    nodes.add(raim5.node_of_block(ref.stripe, j, self.n))
        nodes.discard(self.failed)
        return tuple(sorted(nodes))


def _member_real_bytes(node: int, n: int, total_bytes: int) -> int:
    if n == 1:
        return total_bytes
    bs = raim5.block_size(total_bytes, n)
    real = 0
    for ref in raim5.data_blocks_of_node(node, n):
        lo, hi = ref.byte_range(bs, n)
        real += max(0, min(hi, total_bytes) - min(lo, total_bytes))
    return real


def build_plan(n: int, total_bytes: int,
               need: Optional[Sequence[Tuple[int, int]]] = None,
               failed: Optional[int] = None) -> LoadPlan:
    """Map global byte `need` (default: everything) through the n-way
    RAIM5 block layout into per-member local reads + the failed member's
    decode sub-ranges."""
    need_n = normalize_ranges(need if need is not None
                              else [(0, total_bytes)], total_bytes)
    if n == 1:
        assert failed is None, "n==1 has no parity to decode from"
        reqs = tuple(RangeReq(a, b, a) for a, b in need_n)
        return LoadPlan(1, total_bytes, need_n, {0: reqs}, (), None)
    bs = raim5.block_size(total_bytes, n)
    reads: Dict[int, List[RangeReq]] = {}
    for node in range(n):
        if node == failed:
            continue
        reqs: List[RangeReq] = []
        for li, ref in enumerate(raim5.data_blocks_of_node(node, n)):
            g_lo, g_hi = ref.byte_range(bs, n)
            for a, b in _intersect(need_n, g_lo, min(g_hi, total_bytes)):
                local = li * bs + (a - g_lo)
                reqs.append(RangeReq(local, local + (b - a), a))
        if reqs:
            reqs.sort(key=lambda r: r.local_lo)
            reads[node] = reqs
    decode: Tuple = ()
    if failed is not None:
        decode = tuple((ref, tuple(subs)) for ref, subs in
                       raim5.blocks_intersecting(failed, n, total_bytes,
                                                 need_n))
    return LoadPlan(n, total_bytes, need_n,
                    {k: tuple(v) for k, v in reads.items()}, decode, failed)


# ---------------------------------------------------------------- sources
class ShmSource:
    """Ranged reads over survivor SMP shared-memory segments at one step
    (`smp.ReadOnlyNode.read_range` — no whole-region copies)."""

    kind = "shm"

    def __init__(self, views: Dict[int, Any], step: int):
        self.views = views
        self.step = step

    @property
    def nodes(self) -> List[int]:
        return sorted(self.views)

    def read_local(self, node: int, lo: int, hi: int) -> np.ndarray:
        return self.views[node].read_range(self.step, lo, hi)

    def read_local_ranges(self, node: int, ranges) -> List[np.ndarray]:
        """Scatter-gather fast path: one clean-buffer lookup for many
        range copies (`ReadOnlyNode.read_ranges`) — what partial plans
        with many small block slices ride on."""
        return self.views[node].read_ranges(self.step, ranges)

    def read_block_range(self, node: int, stripe: int, index: int,
                         o1: int, o2: int) -> np.ndarray:
        return self.views[node].read_block_range(self.step, stripe, index,
                                                 o1, o2)

    def read_parity_range(self, stripe: int, o1: int, o2: int) -> np.ndarray:
        return self.views[stripe].read_parity_range(self.step, o1, o2)

    def meta(self, node: int) -> dict:
        return pickle.loads(self.views[node].meta(self.step))


class FileSource:
    """Ranged reads over a persisted REFT-Ckpt family (`.reft` files):
    one positioned read (`os.pread`) per range instead of reading every
    member file whole.  pread carries its own offset, so the executor's
    member-read threads and the decode task can hit the same file handle
    concurrently without a seek race.  Discovers the family's own layout
    (saved n, total bytes) from the pickled heads, which is what makes
    elastic n->m disk restores work."""

    kind = "file"

    def __init__(self, paths: Dict[int, str]):
        import os
        from repro_torch.core.smp import NodeLayout
        self._files: Dict[int, Any] = {}
        self._data_off: Dict[int, int] = {}
        self.heads: Dict[int, dict] = {}
        try:
            for node, path in sorted(paths.items()):
                f = open(path, "rb")
                self._files[node] = f          # owned even if the head is
                self.heads[node] = pickle.load(f)   # garbage (see except)
                self._data_off[node] = f.tell()
        except BaseException:
            self.close()                       # junk/torn family: no fd leak
            raise
        any_head = next(iter(self.heads.values()))
        self.n = any_head["n"]
        self.total_bytes = any_head["total_bytes"]
        self.step = any_head["step"]
        self.layout = NodeLayout(self.n, self.total_bytes)
        self._pread = os.pread

    @property
    def nodes(self) -> List[int]:
        return sorted(self._files)

    def read_local(self, node: int, lo: int, hi: int) -> np.ndarray:
        fd = self._files[node].fileno()
        return np.frombuffer(
            self._pread(fd, hi - lo, self._data_off[node] + lo), np.uint8)

    def read_block_range(self, node: int, stripe: int, index: int,
                         o1: int, o2: int) -> np.ndarray:
        base = raim5.local_block_index(node, stripe, index, self.n) \
            * self.layout.bs
        return self.read_local(node, base + o1, base + o2)

    def read_parity_range(self, stripe: int, o1: int, o2: int) -> np.ndarray:
        base = self.layout.own_bytes
        return self.read_local(stripe, base + o1, base + o2)

    def meta(self, node: int) -> dict:
        return pickle.loads(self.heads[node]["meta"])

    def close(self) -> None:
        for f in self._files.values():
            try:
                f.close()
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ObjectSource:
    """Ranged reads over a remote REFT-Ckpt family (tier 4): shard
    objects in an object store, addressed by the family MANIFEST instead
    of pickled file heads — no local staging copy, every `LoadPlan`
    range becomes one `read_range` straight into plan assembly, and the
    saved topology comes from the manifest so elastic n->m restores work
    against remote families exactly like local ones.

    Deliberately store-agnostic: takes any object with
    `read_range(key, lo, hi)` plus a plain manifest dict, and an
    optional `retry` wrapper (`callable -> result`) recovery builds from
    the configured backoff policy — this module never imports
    `repro_torch.store` (the store package sits above the loader)."""

    kind = "object"

    def __init__(self, store, manifest: dict, retry=None):
        from repro_torch.core.smp import NodeLayout
        self._store = store
        self._retry = retry if retry is not None else (lambda fn: fn())
        self.manifest = manifest
        self.n = int(manifest["n"])
        self.total_bytes = int(manifest["total_bytes"])
        self.step = int(manifest["step"])
        self.layout = NodeLayout(self.n, self.total_bytes)
        self._nodes = {int(k): v for k, v in manifest["nodes"].items()}
        self._meta: Dict[int, dict] = {}

    @property
    def nodes(self) -> List[int]:
        return sorted(self._nodes)

    def read_local(self, node: int, lo: int, hi: int) -> np.ndarray:
        ent = self._nodes[node]
        off = int(ent["data_off"])
        return self._retry(lambda: self._store.read_range(
            ent["key"], off + lo, off + hi))

    def read_block_range(self, node: int, stripe: int, index: int,
                         o1: int, o2: int) -> np.ndarray:
        base = raim5.local_block_index(node, stripe, index, self.n) \
            * self.layout.bs
        return self.read_local(node, base + o1, base + o2)

    def read_parity_range(self, stripe: int, o1: int, o2: int) -> np.ndarray:
        base = self.layout.own_bytes
        return self.read_local(stripe, base + o1, base + o2)

    def meta(self, node: int) -> dict:
        if node not in self._meta:
            ent = self._nodes[node]
            head_blob = self._retry(lambda: self._store.read_range(
                ent["key"], 0, int(ent["data_off"])))
            head = pickle.loads(bytes(head_blob))
            self._meta[node] = pickle.loads(head["meta"])
        return self._meta[node]

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class DeltaLayer:
    """One `.reftd` delta family as an overlay layer: per node, the
    buffer-local extents its flight span rewrote plus a reader over the
    concatenated payload bytes.  The head carries the FULL merged
    snapshot meta + per-stripe digest table of its step, so the newest
    layer alone answers every verification question about the chain."""

    def __init__(self, step: int, base_step: int):
        self.step = int(step)
        self.base_step = int(base_step)
        self.extents: Dict[int, List[Tuple[int, int]]] = {}
        self.prefix: Dict[int, List[int]] = {}   # payload offset per extent
        self._payload: Dict[int, Callable] = {}  # node -> read(lo, hi)
        self._head: Dict[int, Any] = {}          # dict, or lazy loader
        self._files: Dict[int, Any] = {}

    def add_node(self, node: int, extents, read_payload, head) -> None:
        ext = [(int(a), int(b)) for a, b in extents]
        pre: List[int] = []
        acc = 0
        for a, b in ext:
            pre.append(acc)
            acc += b - a
        self.extents[node] = ext
        self.prefix[node] = pre
        self._payload[node] = read_payload
        self._head[node] = head

    @property
    def nodes(self) -> List[int]:
        return sorted(self.extents)

    def head(self, node: int) -> dict:
        h = self._head[node]
        if callable(h):
            h = self._head[node] = h()
        return h

    def read(self, node: int, off_lo: int, off_hi: int) -> np.ndarray:
        """Payload bytes [off_lo, off_hi) of `node`'s delta object."""
        return self._payload[node](off_lo, off_hi)

    def close(self) -> None:
        for f in self._files.values():
            try:
                f.close()
            except Exception:
                pass

    @classmethod
    def from_files(cls, paths: Dict[int, str]) -> "DeltaLayer":
        """Open one local `.reftd` family ({node: path})."""
        import os
        layer = None
        files: Dict[int, Any] = {}
        try:
            for node, path in sorted(paths.items()):
                f = open(path, "rb")
                files[node] = f
                head = pickle.load(f)
                data_off = f.tell()
                if layer is None:
                    layer = cls(head["step"], head["base_step"])
                fd = f.fileno()
                layer.add_node(
                    node, head["extents"],
                    lambda lo, hi, fd=fd, off=data_off: np.frombuffer(
                        os.pread(fd, hi - lo, off + lo), np.uint8),
                    head)
        except BaseException:
            for f in files.values():
                try:
                    f.close()
                except Exception:
                    pass
            raise
        layer._files = files
        return layer

    @classmethod
    def from_objects(cls, store, manifest: dict, retry=None) -> "DeltaLayer":
        """Open one remote delta family from its manifest (node records
        carry `base_step`/`extents`/`data_off`, so only a node's head —
        needed for `meta()` — is fetched lazily)."""
        rt = retry if retry is not None else (lambda fn: fn())
        nodes = {int(k): v for k, v in manifest["nodes"].items()}
        any_ent = next(iter(nodes.values()))
        layer = cls(manifest["step"],
                    manifest.get("base_step", any_ent.get("base_step")))
        for node, ent in sorted(nodes.items()):
            off = int(ent["data_off"])
            key = ent["key"]

            def read_payload(lo, hi, key=key, off=off):
                return rt(lambda: store.read_range(key, off + lo, off + hi))

            def load_head(key=key, off=off):
                blob = rt(lambda: store.read_range(key, 0, off))
                return pickle.loads(bytes(blob))

            layer.add_node(node, ent["extents"], read_payload, load_head)
        return layer


class ChainSource:
    """Keyframe + delta-chain resolver presenting the standard source
    interface, so `LoadPlan` executors, RAIM5 decode, and per-stripe
    verification run unchanged over a delta family.

    `base` is a full-family source (`FileSource`/`ObjectSource`/shm
    views); `layers` are the `.reftd` deltas oldest -> newest, each
    linking to its predecessor's step.  A buffer-local read resolves
    newest layer first (its extents override), falls through older
    layers, and bottoms out at the keyframe.  `meta()` serves the NEWEST
    layer's merged table — the digests of the resolved step — which is
    exactly what makes chain reads verify like full-shard reads."""

    kind = "chain"

    def __init__(self, base, layers: Sequence[DeltaLayer]):
        from repro_torch.core.smp import NodeLayout
        self.base = base
        self.layers = list(layers)
        prev = int(base.step)
        for ly in self.layers:
            if ly.base_step != prev:
                raise ValueError(
                    f"broken delta chain: layer for step {ly.step} links "
                    f"to base {ly.base_step}, expected {prev}")
            prev = ly.step
        self.n = base.n
        self.total_bytes = base.total_bytes
        self.layout = NodeLayout(self.n, self.total_bytes)
        self.step = self.layers[-1].step if self.layers else int(base.step)
        self._meta: Dict[int, dict] = {}

    @property
    def nodes(self) -> List[int]:
        return self.base.nodes

    # ----------------------------------------------- overlay resolution
    def locate_spans(self, node: int, lo: int, hi: int
                     ) -> List[Tuple[int, int, int, int]]:
        """Resolve buffer-local [lo, hi) newest-first into
        `(layer_idx, payload_off, lo2, hi2)` spans sorted by `lo2`;
        `layer_idx == -1` means the keyframe serves it (and
        `payload_off == lo2`).  Exposed for the scrubber, which must
        route repair WRITES to the same layer that serves the bytes."""
        spans: List[Tuple[int, int, int, int]] = []
        self._locate(node, lo, hi, len(self.layers) - 1, spans)
        spans.sort(key=lambda s: s[2])
        return spans

    def _locate(self, node, lo, hi, li, out) -> None:
        if lo >= hi:
            return
        if li < 0:
            out.append((-1, lo, lo, hi))
            return
        layer = self.layers[li]
        ext = layer.extents.get(node, [])
        pos = lo
        i = bisect.bisect_right([a for a, _ in ext], pos) - 1
        if i < 0 or ext[i][1] <= pos:
            i += 1
        while pos < hi and i < len(ext):
            a, b = ext[i]
            if a >= hi:
                break
            if a > pos:                       # hole: older layers serve it
                self._locate(node, pos, min(a, hi), li - 1, out)
                pos = min(a, hi)
            c = min(b, hi)
            if c > pos:
                off = layer.prefix[node][i] + (pos - a)
                out.append((li, off, pos, c))
                pos = c
            i += 1
        if pos < hi:
            self._locate(node, pos, hi, li - 1, out)

    def _read_span(self, node: int, span) -> np.ndarray:
        li, off, a, b = span
        if li < 0:
            return self.base.read_local(node, a, b)
        return self.layers[li].read(node, off, off + (b - a))

    # ------------------------------------------------- source interface
    def read_local(self, node: int, lo: int, hi: int) -> np.ndarray:
        spans = self.locate_spans(node, lo, hi)
        if len(spans) == 1:
            return self._read_span(node, spans[0])
        out = np.empty(hi - lo, np.uint8)
        for span in spans:
            out[span[2] - lo:span[3] - lo] = self._read_span(node, span)
        return out

    def read_block_range(self, node: int, stripe: int, index: int,
                         o1: int, o2: int) -> np.ndarray:
        base = raim5.local_block_index(node, stripe, index, self.n) \
            * self.layout.bs
        return self.read_local(node, base + o1, base + o2)

    def read_parity_range(self, stripe: int, o1: int, o2: int) -> np.ndarray:
        base = self.layout.own_bytes
        return self.read_local(stripe, base + o1, base + o2)

    def meta(self, node: int) -> dict:
        if node not in self._meta:
            if self.layers:
                self._meta[node] = pickle.loads(
                    self.layers[-1].head(node)["meta"])
            else:
                self._meta[node] = self.base.meta(node)
        return self._meta[node]

    def close(self) -> None:
        for ly in self.layers:
            ly.close()
        close = getattr(self.base, "close", None)
        if close is not None:
            close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ------------------------------------------------------------------ stats
@dataclass
class LoadStats:
    """Per-phase restore accounting (surfaced as `RestoreResult.load`).

    Counters measure the TOTAL work the restore performed — including
    CRC probe traffic, demotion retries, and candidate steps that were
    abandoned — not just the final successful plan's footprint; that is
    what restart latency is made of.  `crc_members` reflects only the
    attempt that produced the result."""
    tier: str = ""                 # ladder rung (filled by the caller)
    source: str = ""               # shm | file | object
    saved_n: int = 0               # layout the snapshot was saved with
    target_n: int = 0              # restoring group size (0 = unspecified)
    resharded: bool = False        # saved_n != target_n (elastic restart)
    bytes_needed: int = 0          # plan coverage of the flat stream
    bytes_read: int = 0            # bytes copied out of sources
    decoded_bytes: int = 0         # failed-member bytes rebuilt from parity
    read_seconds: float = 0.0      # direct-read span: first read start to
                                   # last read completion (plus CRC probe
                                   # traffic, which precedes the plan)
    decode_seconds: float = 0.0    # decode span: first decode start to
                                   # last decode end (overlaps reads)
    overlap_seconds: float = 0.0   # intersection of the two spans, so
                                   # read + decode - overlap never
                                   # double-counts concurrent phases
    h2d_seconds: float = 0.0       # overlapped h2d (device_put) drain
    wall_seconds: float = 0.0
    members: Tuple[int, ...] = ()  # members actually read
    crc_members: Tuple[int, ...] = ()  # members CRC-verified in-pass
    probe_segments: int = 0        # per-stripe digests verified (partial
                                   # plans: segments read, not whole shards)
    parallel_readers: int = 0
    # adaptive scheduler accounting (readsched.ChunkScheduler)
    sched: str = ""                # "" = legacy FCFS executor
    stolen_chunks: int = 0         # chunks run off their home affinity
    parity_rerouted_bytes: int = 0  # live-member bytes served via parity
    rerouted_members: Tuple[int, ...] = ()
    hedged_reads: int = 0          # duplicate tail reads issued
    hedged_wins: int = 0           # duplicates that beat the original
    source_bandwidth: Dict[str, float] = field(
        default_factory=dict)      # "kind:node" -> EWMA bytes/s

    def to_dict(self) -> dict:
        return {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in self.__dict__.items()}


# ------------------------------------------------------------------ sinks
class FlatSink:
    """Scatter into one contiguous buffer (the compat/monolithic shape).
    Plan writes land in provably disjoint ranges (each global byte is
    served by exactly one block or decode piece), so the parallel reader
    threads scatter without a lock."""

    def __init__(self, total_bytes: int):
        self.buf = np.zeros(total_bytes, np.uint8)

    def write(self, global_lo: int, data: np.ndarray) -> None:
        self.buf[global_lo:global_lo + data.nbytes] = data


class LeafSink:
    """Scatter straight into per-leaf arrays (no full-state intermediate
    buffer).  Tracks per-leaf remaining bytes from the plan's coverage;
    a leaf whose covered bytes have all arrived is handed to `on_leaf`
    immediately — the hook the overlapped-h2d drain rides on.

    A PARTIALLY covered leaf (a member shard or mesh slab boundary cuts
    through it) starts from `template_bytes(i)` so its uncovered bytes
    keep the template's values — consistent with leaves the plan does
    not touch at all."""

    def __init__(self, spec: FlatSpec, need: Sequence[Tuple[int, int]],
                 on_leaf: Optional[Callable[[int, np.ndarray], None]] = None,
                 template_bytes: Optional[
                     Callable[[int], np.ndarray]] = None):
        self.spec = spec
        self.offsets = [l.offset for l in spec.leaves]
        self.on_leaf = on_leaf
        self._template = template_bytes
        self._arrs: Dict[int, np.ndarray] = {}
        self._left: Dict[int, int] = {}
        self._lock = named_lock("loader.assembler")
        for lo, hi in need:
            l0 = max(0, bisect.bisect_right(self.offsets, lo) - 1)
            for i in range(l0, len(spec.leaves)):
                ls = spec.leaves[i]
                if ls.offset >= hi:
                    break
                a, b = max(lo, ls.offset), min(hi, ls.offset + ls.nbytes)
                if b > a:
                    self._left[i] = self._left.get(i, 0) + (b - a)
        self._covered0 = dict(self._left)

    @property
    def covered(self) -> Tuple[int, ...]:
        return tuple(sorted(self._left))

    def _leaf_arr(self, i: int) -> np.ndarray:
        arr = self._arrs.get(i)
        if arr is None:
            nb = self.spec.leaves[i].nbytes
            if self._template is not None and self._covered0[i] < nb:
                arr = np.array(self._template(i), np.uint8, copy=True)
            else:
                arr = np.zeros(nb, np.uint8)
            self._arrs[i] = arr
        return arr

    def write(self, global_lo: int, data: np.ndarray) -> None:
        lo, hi = global_lo, global_lo + data.nbytes
        i = max(0, bisect.bisect_right(self.offsets, lo) - 1)
        segs: List[Tuple[int, np.ndarray, int, int]] = []
        with self._lock:                   # allocation only
            pos = lo
            while pos < hi and i < len(self.spec.leaves):
                ls = self.spec.leaves[i]
                a, b = max(pos, ls.offset), min(hi, ls.offset + ls.nbytes)
                if b > a:
                    segs.append((i, self._leaf_arr(i), a, b))
                pos = b
                i += 1
        # plan writes are disjoint: the memcpys need no lock
        for i, arr, a, b in segs:
            off = self.spec.leaves[i].offset
            arr[a - off:b - off] = data[a - lo:b - lo]
        done: List[Tuple[int, np.ndarray]] = []
        with self._lock:                   # completion bookkeeping AFTER
            for i, arr, a, b in segs:      # the bytes actually landed
                left = self._left[i] - (b - a)
                self._left[i] = left
                if left <= 0:
                    done.append((i, arr))
        if self.on_leaf is not None:
            for i, arr in done:
                self.on_leaf(i, arr)

    def leaf_bytes(self, i: int) -> Optional[np.ndarray]:
        return self._arrs.get(i)


# --------------------------------------------------------------- executor
def stream_crc(read: Callable[[int, int], np.ndarray], span: int,
               chunk_bytes: int = CHUNK_BYTES) -> int:
    """zlib CRC32 of bytes [0, span) served by `read(lo, hi)`, streamed in
    fixed chunks (never holds more than one chunk)."""
    crc = 0
    for lo in range(0, span, chunk_bytes):
        crc = zlib.crc32(read(lo, min(lo + chunk_bytes, span)), crc)
    return crc


def stripe_table(meta: dict) -> Optional[Tuple[int, List[int]]]:
    """(segment_bytes, per-segment digests) from a snapshot meta, or None
    when the snapshot predates per-stripe digests (legacy / serial
    engine).  Segments are the member's local RAIM5 blocks (the whole own
    region for n == 1), recorded by the SMP at publish time."""
    table = meta.get("crc_stripes")
    if not isinstance(table, dict):
        return None
    seg, crcs = table.get("seg"), table.get("crcs")
    if not seg or not crcs:
        return None
    return int(seg), list(crcs)


def has_stripe_digests(source, node: int) -> bool:
    try:
        return stripe_table(source.meta(node)) is not None
    except Exception:
        return False


def plan_local_ranges(plan: LoadPlan) -> Dict[int, List[Tuple[int, int]]]:
    """Per-member LOCAL own-region byte ranges the executor will read:
    the plan's direct reads PLUS the stripe-sibling block sub-ranges
    feeding the failed member's decode (parity inputs are covered
    separately by `crc_parity`).  This is the footprint a per-stripe
    digest probe must cover — and nothing more."""
    out: Dict[int, List[Tuple[int, int]]] = {}
    for node, reqs in plan.reads.items():
        out.setdefault(node, []).extend(
            (r.local_lo, r.local_hi) for r in reqs)
    if plan.failed is not None and plan.decode:
        bs = raim5.block_size(plan.total_bytes, plan.n)
        for ref, subs in plan.decode:
            for j in range(plan.n - 1):
                if j == ref.index:
                    continue
                nd = raim5.node_of_block(ref.stripe, j, plan.n)
                if nd == plan.failed:
                    continue
                base = raim5.local_block_index(nd, ref.stripe, j,
                                               plan.n) * bs
                out.setdefault(nd, []).extend(
                    (base + o1, base + o2) for o1, o2 in subs)
    return out


def probe_crc(plan: LoadPlan, source, *,
              chunk_bytes: int = CHUNK_BYTES,
              workers: Optional[int] = None,
              skip: Optional[set] = None,
              stats: Optional[LoadStats] = None,
              full_verified: Optional[set] = None) -> List[int]:
    """CRC probe of every member the plan reads — including the stripe
    siblings and parity holders feeding a failed member's decode
    (`plan.touched_members`), since corrupt decode inputs would XOR into
    silently wrong reconstructed bytes.

    Members whose snapshot meta carries a per-stripe digest table verify
    ONLY the stripe segments the plan actually touches (read + crc per
    segment) — the whole point of publishing the table.  Members without
    one (legacy / serial-engine snapshots) fall back to streaming the
    full own region against the whole-region `crc_own`.  Returns the
    corrupt members; probe traffic is counted into `stats`.  `skip` names
    members already verified in a previous round (a demotion retry must
    not re-stream their shards).  `full_verified` (a set, filled in
    place) receives the members verified against the WHOLE-region digest
    — the only ones a retry may safely skip, since a stripe probe covers
    just the current plan's segments."""
    st = stats if stats is not None else LoadStats()
    bs = raim5.block_size(plan.total_bytes, plan.n) if plan.n > 1 else 0
    own_bytes = (plan.total_bytes if plan.n == 1 else (plan.n - 1) * bs)
    decode_stripes = {ref.stripe for ref, _ in plan.decode}
    local = plan_local_ranges(plan)
    lock = named_lock("loader.probe")
    t0 = time.perf_counter()

    def probe_segments(node: int, seg: int, crcs: List[int]) -> bool:
        """Verify the touched segments of `node` against its table."""
        idxs = sorted({i for lo, hi in local.get(node, ())
                       for i in range(lo // seg,
                                      (max(hi, lo + 1) - 1) // seg + 1)})
        for i in idxs:
            if i >= len(crcs):
                return False               # malformed table: distrust
            a, b = i * seg, min((i + 1) * seg, own_bytes)
            crc = stream_crc(
                lambda lo, hi, a=a: source.read_local(node, a + lo, a + hi),
                b - a, chunk_bytes)
            with lock:
                st.bytes_read += b - a
                st.probe_segments += 1
            if (crc & 0xFFFFFFFF) != (crcs[i] & 0xFFFFFFFF):
                return False
        return True

    def probe(node: int) -> Optional[int]:
        try:
            meta = source.meta(node)
        except Exception:
            return node
        expect = meta.get("crc_own")
        table = stripe_table(meta)
        if table is not None:
            seg, crcs = table
            if not probe_segments(node, seg, crcs):
                return node
        elif expect is not None:
            crc = stream_crc(lambda lo, hi: source.read_local(node, lo, hi),
                             own_bytes, chunk_bytes)
            with lock:
                st.bytes_read += own_bytes
            if (crc & 0xFFFFFFFF) != (expect & 0xFFFFFFFF):
                return node
            if full_verified is not None:
                with lock:
                    full_verified.add(node)
        if node in decode_stripes:           # its parity feeds the decode
            exp_p = meta.get("crc_parity")
            if exp_p is not None:
                crc = stream_crc(
                    lambda lo, hi: source.read_parity_range(node, lo, hi),
                    bs, chunk_bytes)
                with lock:
                    st.bytes_read += bs
                if (crc & 0xFFFFFFFF) != (exp_p & 0xFFFFFFFF):
                    return node
        if table is None and expect is None:   # legacy: nothing to verify
            return None
        with lock:
            st.crc_members += (node,)
        return None

    nodes = [nd for nd in plan.touched_members
             if not skip or nd not in skip]
    nw = workers or min(8, max(1, len(nodes)))
    if nw == 1 or len(nodes) <= 1:
        bad = [probe(nd) for nd in nodes]
    else:
        with ThreadPoolExecutor(max_workers=nw) as pool:
            bad = list(pool.map(probe, nodes))
    st.crc_members = tuple(sorted(set(st.crc_members)))
    st.read_seconds += time.perf_counter() - t0
    return sorted(nd for nd in bad if nd is not None)


def execute_plan(plan: LoadPlan, source, sink, *,
                 verify: bool = True,
                 workers: Optional[int] = None,
                 chunk_bytes: int = CHUNK_BYTES,
                 stats: Optional[LoadStats] = None,
                 sched=None) -> LoadStats:
    """Run the plan: parallel per-member ranged reads (with the member's
    own-region CRC folded into the pass when the plan covers its full
    shard), plus range-limited RAIM5 decode of the failed member.

    `sched` (a `readsched.SchedConfig`) selects the executor: None or
    mode "fcfs" runs the legacy one-task-per-member path below; "steal" /
    "adaptive" route through `readsched.ChunkScheduler` (chunked work
    stealing, EWMA bandwidth model, parity-alternative routing, hedged
    tail reads, pipelined decode).  A non-zero `sched.restore_bw_limit`
    throttles EITHER path through a shared token bucket, mirroring the
    persist side's `persist_bw_limit`.

    Raises `CrcMismatch` when a fully-read member's streamed digest does
    not match its recorded `crc_own` — callers demote that member and
    re-plan (RAIM5's single-member budget permitting).  The adaptive
    path may also raise `readsched.SourceLost` (a member died mid-read
    and could not be cleanly rerouted to parity); the ladder demotes it
    the same way."""
    st = stats if stats is not None else LoadStats()
    if sched is not None and getattr(sched, "restore_bw_limit", 0.0) > 0:
        from .readsched import BucketedSource
        from .smp import _TokenBucket
        if not isinstance(source, BucketedSource):
            source = BucketedSource(
                source, _TokenBucket(sched.restore_bw_limit,
                                     threadsafe=True))
    if sched is not None and sched.mode != "fcfs":
        from .readsched import ChunkScheduler
        return ChunkScheduler(plan, source, sink, verify=verify,
                              cfg=sched, stats=st).run()
    st.source = getattr(source, "kind", "")
    st.saved_n = plan.n
    st.bytes_needed = plan.bytes_needed
    st.members = tuple(sorted(plan.reads))
    st.sched = "fcfs"
    if verify:
        st.crc_members = ()    # only the attempt that produced the result
                               # counts (a CrcMismatch retry re-enters here);
                               # verify=False keeps a prior probe's record
    lock = named_lock("loader.gather")
    t_wall = time.perf_counter()
    marks = {"read_end": 0.0, "d0": 0.0, "d1": 0.0}

    expected: Dict[int, Any] = {}
    if verify:
        for node in plan.reads:
            try:
                expected[node] = source.meta(node).get("crc_own")
            except Exception:
                # unreadable meta = untrustworthy member: demote it like a
                # digest mismatch (the pre-loader verify_crc did the same)
                expected[node] = _META_BAD

    own_bytes = (plan.total_bytes if plan.n == 1 else
                 (plan.n - 1) * raim5.block_size(plan.total_bytes, plan.n))

    def read_member(node: int):
        reqs = plan.reads[node]
        nread = 0
        expect = expected.get(node)
        if expect is _META_BAD:
            raise CrcMismatch(
                node, reason=f"node {node} snapshot meta unreadable")
        if verify and expect is not None and plan.member_covered(node):
            # incremental CRC folded into the read pass: stream the FULL
            # local own region (incl. the tail block's zero padding the
            # engine checksummed) in fixed chunks, fold crc32, and scatter
            # the pieces the plan needs as they fly by — one pass over the
            # bytes instead of probe-then-read.
            crc = 0
            ri = 0
            for lo in range(0, own_bytes, chunk_bytes):
                hi = min(lo + chunk_bytes, own_bytes)
                data = source.read_local(node, lo, hi)
                nread += data.nbytes
                crc = zlib.crc32(data, crc)
                while ri < len(reqs) and reqs[ri].local_lo < hi:
                    r = reqs[ri]
                    a, b = max(r.local_lo, lo), min(r.local_hi, hi)
                    if b > a:
                        sink.write(r.global_lo + (a - r.local_lo),
                                   data[a - lo:b - lo])
                    if r.local_hi <= hi:
                        ri += 1
                    else:
                        break
            if (crc & 0xFFFFFFFF) != (expect & 0xFFFFFFFF):
                raise CrcMismatch(node, expect, crc)
            with lock:
                st.crc_members += (node,)
        else:
            pieces = [(a, min(a + chunk_bytes, r.local_hi),
                       r.global_lo + (a - r.local_lo))
                      for r in reqs
                      for a in range(r.local_lo, r.local_hi, chunk_bytes)]
            batched = getattr(source, "read_local_ranges", None)
            if batched is None:
                for a, b, g in pieces:
                    data = source.read_local(node, a, b)
                    nread += data.nbytes
                    sink.write(g, data)
            else:
                # scatter-gather: batch pieces per source lookup, bounded
                # to ~one chunk of live bytes
                i = 0
                while i < len(pieces):
                    group = []
                    acc = 0
                    while i < len(pieces) and acc < chunk_bytes \
                            and len(group) < 256:
                        group.append(pieces[i])
                        acc += pieces[i][1] - pieces[i][0]
                        i += 1
                    datas = batched(node, [(a, b) for a, b, _ in group])
                    for (a, b, g), data in zip(group, datas):
                        nread += data.nbytes
                        sink.write(g, data)
        with lock:
            st.bytes_read += nread
            marks["read_end"] = max(marks["read_end"],
                                    time.perf_counter())

    def run_decode():
        if plan.failed is None or not plan.decode:
            return
        t0 = time.perf_counter()
        nread = [0]
        if verify:
            # decode inputs: a corrupt survivor PARITY block would XOR
            # silently into the reconstructed bytes — verify each feeding
            # stripe's parity digest (recorded at publish) before decoding
            bs = raim5.block_size(plan.total_bytes, plan.n)
            for s in sorted({ref.stripe for ref, _ in plan.decode}):
                try:
                    expect = source.meta(s).get("crc_parity")
                except Exception:
                    expect = None          # meta-bad members are demoted
                if expect is None:         # by the read path / probe
                    continue               # (legacy snapshot: no digest)
                crc = stream_crc(
                    lambda lo, hi: source.read_parity_range(s, lo, hi),
                    bs, chunk_bytes)
                nread[0] += bs
                if (crc & 0xFFFFFFFF) != (expect & 0xFFFFFFFF):
                    raise CrcMismatch(
                        s, reason=f"node {s} parity region CRC mismatch "
                                  f"(expect {expect:#010x}, got "
                                  f"{crc:#010x})")

        def read_block_range(nd, s, j, o1, o2):
            data = source.read_block_range(nd, s, j, o1, o2)
            nread[0] += data.nbytes
            return data

        def read_parity_range(s, o1, o2):
            data = source.read_parity_range(s, o1, o2)
            nread[0] += data.nbytes
            return data

        bs = raim5.block_size(plan.total_bytes, plan.n)
        rec = raim5.decode_node_ranges(plan.failed, plan.n,
                                       plan.total_bytes, plan.need,
                                       read_block_range, read_parity_range)
        for (s, j), pieces in rec.items():
            g_lo, _ = raim5.BlockRef(s, j).byte_range(bs, plan.n)
            for o1, o2, data in pieces:
                sink.write(g_lo + o1, data)
                with lock:
                    st.decoded_bytes += o2 - o1
        with lock:
            st.bytes_read += nread[0]
            marks["d0"], marks["d1"] = t0, time.perf_counter()

    tasks: List[Callable[[], None]] = [
        (lambda nd=node: read_member(nd)) for node in plan.reads]
    tasks.append(run_decode)
    nw = workers or min(8, max(1, len(tasks)))
    st.parallel_readers = min(nw, len(tasks))
    t0 = time.perf_counter()
    if nw == 1 or len(tasks) == 1:
        for t in tasks:
            t()
    else:
        with ThreadPoolExecutor(max_workers=nw) as pool:
            futs = [pool.submit(t) for t in tasks]
            err = None
            for f in futs:
                try:
                    f.result()
                except BaseException as e:
                    # CrcMismatch beats secondaries: a concurrent member's
                    # transient read error must not mask the demote-and-
                    # replan signal the ladder acts on
                    if err is None or (isinstance(e, CrcMismatch)
                                       and not isinstance(err, CrcMismatch)):
                        err = e
            if err is not None:
                raise err
    st.crc_members = tuple(sorted(st.crc_members))
    # consistent phase attribution: read_seconds is the direct-read span,
    # decode_seconds the decode task's span, overlap_seconds their
    # intersection — read + decode - overlap never double-counts the
    # decode work that ran inside the read window
    if marks["read_end"]:
        st.read_seconds += marks["read_end"] - t0
    if marks["d1"]:
        st.decode_seconds += marks["d1"] - marks["d0"]
        r_end = marks["read_end"] or t0
        st.overlap_seconds += max(
            0.0, min(r_end, marks["d1"]) - max(t0, marks["d0"]))
    st.wall_seconds += time.perf_counter() - t_wall
    return st


def load_bytes(plan: LoadPlan, source, *, verify: bool = True,
               workers: Optional[int] = None,
               stats: Optional[LoadStats] = None,
               sched=None) -> Tuple[np.ndarray, LoadStats]:
    """Plan -> one contiguous flat buffer (zeros outside `plan.need`)."""
    sink = FlatSink(plan.total_bytes)
    st = execute_plan(plan, source, sink, verify=verify, workers=workers,
                      stats=stats, sched=sched)
    return sink.buf, st


def load_tree(plan: LoadPlan, source, template: Any, spec: FlatSpec, *,
              verify: bool = True, device_put: bool = False,
              workers: Optional[int] = None,
              stats: Optional[LoadStats] = None,
              sched=None) -> Tuple[Any, LoadStats]:
    """Plan -> pytree, assembled leaf-streamed: each leaf's array is
    built directly from its ranged reads (no full-state buffer), and with
    `device_put=True` finished leaves start their h2d transfer while
    later leaves' ranges are still being read.

    Leaves (or parts of leaves) the plan does not cover keep the
    template's values (partial restores: a leaf filter / member shard /
    mesh slice).

    Leaves come back as host tensors; with `device_put=True` each one
    moves to the device of its template leaf."""
    import torch

    st = stats if stats is not None else LoadStats()
    flat = leaf_arrays(template)
    done: Dict[int, Any] = {}
    h2d_lock = named_lock("loader.h2d")

    def to_tensor(i: int, raw: np.ndarray):
        ls = spec.leaves[i]
        return tensor_from_bytes(raw, ls.dtype, ls.shape)

    def finish(i: int, raw: np.ndarray):
        arr = to_tensor(i, raw)
        if device_put and isinstance(flat[i], torch.Tensor):
            t0 = time.perf_counter()
            # async under the remaining reads
            arr = arr.pin_memory().to(flat[i].device, non_blocking=True) \
                if flat[i].is_cuda else arr
            with h2d_lock:
                st.h2d_seconds += time.perf_counter() - t0
        done[i] = arr

    def template_bytes(i: int) -> np.ndarray:
        return host_bytes(flat[i])

    sink = LeafSink(spec, plan.need, on_leaf=finish,
                    template_bytes=template_bytes)
    execute_plan(plan, source, sink, verify=verify, workers=workers,
                 stats=st, sched=sched)
    out = []
    for i, ls in enumerate(spec.leaves):
        arr = done.get(i)
        if arr is None:
            raw = sink.leaf_bytes(i)
            if raw is None:               # uncovered leaf: template value
                out.append(flat[i])
                continue
            arr = to_tensor(i, raw)
        out.append(arr)
    if device_put and torch.cuda.is_available():
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        st.h2d_seconds += time.perf_counter() - t0
    return tree_unflatten(template, out), st


# ------------------------------------------------- target -> need ranges
def need_for_leaves(spec: FlatSpec, select) -> List[Tuple[int, int]]:
    """Global ranges of the leaves whose path matches `select` (a callable
    path -> bool, or an iterable of substrings)."""
    if not callable(select):
        subs = tuple(select)
        select = lambda p: any(s in p for s in subs)   # noqa: E731
    return [(ls.offset, ls.offset + ls.nbytes)
            for ls in spec.leaves if select(ls.path)]


def member_shard_need(m: int, member: int, total_bytes: int
                      ) -> List[Tuple[int, int]]:
    """Global ranges of `member`'s own data blocks under an m-way RAIM5
    layout — what one rank of the NEW (restoring) group must load when an
    n-member snapshot is resharded onto m members."""
    if m == 1:
        return [(0, total_bytes)]
    bs = raim5.block_size(total_bytes, m)
    out = []
    for ref in raim5.data_blocks_of_node(member, m):
        lo, hi = ref.byte_range(bs, m)
        out.append((min(lo, total_bytes), min(hi, total_bytes)))
    return out


def _leaf_slab_ranges(ls, dim: int, idx: int, k: int
                      ) -> Optional[List[Tuple[int, int]]]:
    """Byte ranges of slab `idx`/`k` along `dim` of one leaf (evenly
    divisible dims only; None = not representable within the range cap)."""
    shape = ls.shape
    if not shape or shape[dim] % k:
        return None
    per = shape[dim] // k
    item = dtype_itemsize(ls.dtype)
    inner = item
    for d in range(dim + 1, len(shape)):
        inner *= shape[d]
    lead = 1
    for d in range(dim):
        lead *= shape[d]
    if lead > MAX_SLAB_RANGES:
        return None
    stride = shape[dim] * inner
    out = []
    for li in range(lead):
        a = ls.offset + li * stride + idx * per * inner
        out.append((a, a + per * inner))
    return out


def need_for_sharding(spec: FlatSpec, shardings: Any, mesh: Any,
                      coord: Dict[str, int]) -> List[Tuple[int, int]]:
    """Global ranges of THIS rank's slice under a `repro_torch.dist`
    sharding: `shardings` is a spec tree (`dist.api.P` leaves, as
    `dist.shardings.state_specs` gives) leaf-aligned with the state,
    adapted to `mesh` (a `DeviceMesh`, or any object with `axis_names` and
    `axis_sizes`) by the same rules training uses (`adapt_spec`), and
    `coord` gives the rank's index on each mesh axis.  Dims the adapted
    spec leaves unsharded (or slabs too strided to enumerate) fall back to
    the whole leaf."""
    from repro_torch.dist.api import P, adapt_spec, axis_names, axis_sizes

    sizes = dict(zip(axis_names(mesh), axis_sizes(mesh)))
    flat_specs = leaf_arrays(shardings)
    assert len(flat_specs) == len(spec.leaves), \
        f"sharding tree has {len(flat_specs)} leaves, state has " \
        f"{len(spec.leaves)}"
    need: List[Tuple[int, int]] = []
    for ls, sp in zip(spec.leaves, flat_specs):
        adapted = adapt_spec(sp, ls.shape, mesh) if len(ls.shape) else P()
        picked = None
        for dim, entry in enumerate(adapted):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            k = 1
            idx = 0
            for nm in names:
                idx = idx * sizes[nm] + coord.get(nm, 0)
                k *= sizes[nm]
            if k > 1:
                picked = (dim, idx, k)
                break                    # first sharded dim bounds the slab
        if picked is None:
            need.append((ls.offset, ls.offset + ls.nbytes))
            continue
        slab = _leaf_slab_ranges(ls, *picked)
        if slab is None:
            need.append((ls.offset, ls.offset + ls.nbytes))
        else:
            need.extend(slab)
    return need


def resolve_need(spec: FlatSpec, target) -> Optional[List[Tuple[int, int]]]:
    """`RestoreTarget` -> global byte ranges (None = full state).

    Filters compose by intersection: a leaf filter restricted to a new
    member's byte shard loads exactly the overlap."""
    if target is None:
        return None
    needs: List[Tuple[Tuple[int, int], ...]] = []
    if getattr(target, "leaves", None):
        needs.append(normalize_ranges(need_for_leaves(spec, target.leaves),
                                      spec.total_bytes))
    if getattr(target, "member", None) is not None:
        m = target.sg_size
        if not m:
            raise ValueError(
                "RestoreTarget.member needs sg_size (the restoring "
                "group's size) to define the member's byte shard")
        if not 0 <= target.member < m:
            raise ValueError(
                f"RestoreTarget.member {target.member} out of range for "
                f"sg_size {m}")
        needs.append(normalize_ranges(
            member_shard_need(m, target.member, spec.total_bytes),
            spec.total_bytes))
    if getattr(target, "shardings", None) is not None \
            and getattr(target, "mesh", None) is not None:
        needs.append(normalize_ranges(
            need_for_sharding(spec, target.shardings, target.mesh,
                              target.coord or {}), spec.total_bytes))
    if not needs:
        return None
    out = needs[0]
    for nxt in needs[1:]:
        acc: List[Tuple[int, int]] = []
        for lo, hi in out:
            acc.extend(_intersect(nxt, lo, hi))
        out = normalize_ranges(acc, spec.total_bytes)
    return list(out)


__all__ = [
    "CHUNK_BYTES", "CrcMismatch", "RangeReq", "LoadPlan", "LoadStats",
    "ShmSource", "FileSource", "ObjectSource", "ChainSource", "DeltaLayer",
    "FlatSink", "LeafSink",
    "normalize_ranges",
    "build_plan", "execute_plan", "load_bytes", "load_tree",
    "need_for_leaves", "member_shard_need", "need_for_sharding",
    "resolve_need", "stripe_table", "has_stripe_digests",
    "plan_local_ranges", "probe_crc", "stream_crc",
]
