"""Bandwidth-adaptive restore read scheduling (the straggler-aware loader).

`loader.execute_plan`'s legacy path hands each surviving member's ranged
reads to one first-come-first-served task, so one slow survivor (a
SIGSTOP'd SMP, a throttled NIC, a cold object-store shard) sets the
restore wall clock.  This module replaces that read side with a chunked
work-queue scheduler:

  * **Chunking + work stealing.**  Each member's reads are split into
    fixed-size, RAIM5-block-aligned chunks on per-source queues.  Workers
    have a home source (affinity keeps the streamed-CRC read pattern
    mostly sequential) but steal queued chunks from the source with the
    worst projected finish time instead of idling at the barrier.
  * **EWMA bandwidth model.**  `SourceBandwidth` folds live per-chunk
    timings into a per-source bandwidth estimate, seeded from priors the
    recovery ladder passes down (previous `LoadStats` / the supervisor's
    `FailureObserver`).
  * **Parity-alternative routing.**  RAIM5 parity today only serves
    *dead* members.  When a slow-but-alive member's projected finish
    exceeds `reroute_factor` x the cost of XOR-reconstructing its
    remaining plan bytes from siblings + parity, the scheduler converts
    those queued chunks into decode work mid-flight.  Single-parity
    budget: at most ONE member is ever rerouted, and only when the plan
    has no failed member.
  * **Hedged tail reads.**  A chunk running far past its bandwidth-model
    expectation gets a duplicate read; first finisher wins the claim,
    the loser is cooperatively cancelled between sub-reads.  Claims are
    CAS-style under the scheduler lock, so no byte range is ever written
    twice (the `LeafSink` per-leaf countdown depends on that).
  * **Pipelined decode.**  Planned decode (a failed member) and rerouted
    decode run as chunk-sized work items on the same worker pool, so XOR
    + parity reads overlap remaining direct I/O instead of serializing
    behind a read barrier.

Byte-identity with the FCFS oracle is the hard invariant: every direct
chunk carries exactly the plan's scatter pieces, rerouted chunks decode
exactly those piece ranges, and verification is preserved — fully-read
members fold per-chunk CRCs (``crc32_combine``) into the recorded
``crc_own``; a rerouted member's directly-read blocks are checked against
its per-stripe digest table instead (reroute requires the table).
"""
from __future__ import annotations

import threading
from repro_torch.analyze.lockgraph import named_condition, named_lock
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from . import raim5
from .crcutil import crc32_combine

# chunk states
_PENDING, _RUNNING, _DONE, _REROUTED = 0, 1, 2, 3


@dataclass(frozen=True)
class SchedConfig:
    """Knobs for the adaptive read scheduler (see module docstring).

    mode: "fcfs" (legacy single-task-per-member path), "steal" (chunked
    queues + work stealing + pipelined decode), or "adaptive" (steal +
    parity-alternative routing + hedged tail reads)."""
    mode: str = "adaptive"
    chunk_bytes: int = 8 << 20
    ewma_alpha: float = 0.4          # weight of the newest chunk timing
    min_samples: int = 1             # live samples before reroute may fire
    reroute_factor: float = 2.0      # direct ETA must exceed this x decode ETA
    min_eta_s: float = 0.05          # ETA floor before reroute pays at all
    hedge_factor: float = 4.0        # chunk age vs expected before hedging
    max_hedges: int = 4              # duplicate reads per restore, total
    inflight_per_source: int = 2     # concurrent readers against one source
    restore_bw_limit: float = 0.0    # bytes/s token bucket (0 = unthrottled)
    workers: Optional[int] = None
    priors: Mapping[str, float] = field(default_factory=dict)  # "kind:node"


class SourceBandwidth:
    """Thread-safe per-source EWMA bandwidth estimates (bytes/second).

    Priors seed the estimate but count zero live samples — decisions
    gated on `min_samples` (parity reroute) wait for real chunk timings;
    steal/hedge heuristics may use the seeded value immediately."""

    def __init__(self, alpha: float = 0.4,
                 priors: Optional[Mapping[str, float]] = None):
        self.alpha = float(alpha)
        self._bw: Dict[str, float] = {}
        self._n: Dict[str, int] = {}
        self._dead: set = set()
        self._lock = named_lock("readsched.bw")
        for k, v in (priors or {}).items():
            if v and v > 0:
                self._bw[k] = float(v)
                self._n[k] = 0

    def observe(self, key: str, nbytes: int, seconds: float) -> None:
        if seconds <= 1e-9 or nbytes <= 0:
            return
        sample = nbytes / seconds
        with self._lock:
            prev = self._bw.get(key)
            self._bw[key] = sample if prev is None else (
                self.alpha * sample + (1.0 - self.alpha) * prev)
            self._n[key] = self._n.get(key, 0) + 1

    def bandwidth(self, key: str) -> Optional[float]:
        with self._lock:
            if key in self._dead:
                return None
            return self._bw.get(key)

    def samples(self, key: str) -> int:
        with self._lock:
            return self._n.get(key, 0)

    def mark_dead(self, key: str) -> None:
        with self._lock:
            self._dead.add(key)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {k: v for k, v in self._bw.items() if k not in self._dead}


class CancelToken:
    """Cooperative cancellation flag, checked between sub-reads."""
    __slots__ = ("cancelled",)

    def __init__(self):
        self.cancelled = False


class SourceLost(RuntimeError):
    """A member's source died mid-read and its chunks could not be
    cleanly converted to parity decode.  The recovery ladder treats this
    like a digest mismatch: demote `node` and re-plan."""

    def __init__(self, node: int, reason: str = ""):
        self.node = node
        super().__init__(reason or f"node {node} source lost mid-restore")


class ThrottledSource:
    """Deterministic slow-source wrapper for tests and benchmarks.

    Serializes each node's reads behind a per-node lock and sleeps
    `nbytes / bw` after the inner read, so node `k`'s effective bandwidth
    is exactly `bw_bytes_s[k]` regardless of reader concurrency — the
    shape of a laggard SMP / throttled NIC.  Parity reads are charged to
    the stripe's holder.  Deliberately exposes no `read_local_ranges`,
    forcing the per-piece path so every byte is throttled."""

    def __init__(self, inner, bw_bytes_s: Mapping[int, float],
                 default_bw: float = float("inf")):
        self._inner = inner
        self._bw = dict(bw_bytes_s)
        self._default = float(default_bw)
        self._locks: Dict[int, threading.Lock] = {}
        self._guard = named_lock("readsched.throttle.guard")
        self.kind = f"slow+{getattr(inner, 'kind', '')}"

    def _charge(self, node: int, nbytes: int):
        bw = self._bw.get(node, self._default)
        with self._guard:
            lk = self._locks.setdefault(
                node, named_lock("readsched.throttle.src"))
        with lk:
            if bw != float("inf") and bw > 0 and nbytes > 0:
                time.sleep(nbytes / bw)

    def nodes(self):
        return self._inner.nodes()

    def meta(self, node: int) -> dict:
        return self._inner.meta(node)

    def read_local(self, node: int, lo: int, hi: int) -> np.ndarray:
        data = self._inner.read_local(node, lo, hi)
        self._charge(node, hi - lo)
        return data

    def read_block_range(self, node: int, stripe: int, index: int,
                         o1: int, o2: int) -> np.ndarray:
        data = self._inner.read_block_range(node, stripe, index, o1, o2)
        self._charge(node, o2 - o1)
        return data

    def read_parity_range(self, stripe: int, o1: int, o2: int) -> np.ndarray:
        data = self._inner.read_parity_range(stripe, o1, o2)
        self._charge(stripe, o2 - o1)
        return data

    def __getattr__(self, name):
        if name in ("read_local_ranges", "locate_spans"):
            raise AttributeError(name)    # force the throttled per-piece path
        return getattr(self._inner, name)


class BucketedSource:
    """Source wrapper charging every read against a shared token bucket —
    the read-side `restore_bw_limit` mirroring the SMP persist worker's
    `persist_bw_limit` (restore reads on a survivor otherwise compete
    unthrottled with its live training / persist traffic)."""

    def __init__(self, inner, bucket):
        self._inner = inner
        self.bucket = bucket
        self.kind = getattr(inner, "kind", "")
        batched = getattr(inner, "read_local_ranges", None)
        if batched is not None:
            def read_local_ranges(node, ranges, _b=batched):
                self.bucket.consume(sum(b - a for a, b in ranges))
                return _b(node, ranges)
            self.read_local_ranges = read_local_ranges

    def nodes(self):
        return self._inner.nodes()

    def meta(self, node: int) -> dict:
        return self._inner.meta(node)

    def read_local(self, node: int, lo: int, hi: int) -> np.ndarray:
        self.bucket.consume(hi - lo)
        return self._inner.read_local(node, lo, hi)

    def read_block_range(self, node: int, stripe: int, index: int,
                         o1: int, o2: int) -> np.ndarray:
        self.bucket.consume(o2 - o1)
        return self._inner.read_block_range(node, stripe, index, o1, o2)

    def read_parity_range(self, stripe: int, o1: int, o2: int) -> np.ndarray:
        self.bucket.consume(o2 - o1)
        return self._inner.read_parity_range(stripe, o1, o2)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _Chunk:
    __slots__ = ("cid", "node", "lo", "hi", "pieces", "vfull", "block",
                 "state", "crc", "hedges", "t_start", "nbytes")

    def __init__(self, cid, node, lo, hi, pieces, vfull, block, nbytes):
        self.cid = cid
        self.node = node
        self.lo = lo                   # local span (verify chunks read all
        self.hi = hi                   # of it; gather chunks just bound it)
        self.pieces = pieces           # [(local_a, local_b, global_a)]
        self.vfull = vfull             # part of a full-region CRC stream
        self.block = block             # local RAIM5 block index (n > 1)
        self.state = _PENDING
        self.crc = 0
        self.hedges = 0
        self.t_start = 0.0
        self.nbytes = nbytes           # bytes a reader must pull


class ChunkScheduler:
    """Executes one `LoadPlan` through the chunked work-stealing path.
    Built per restore attempt; `run()` raises `CrcMismatch` / `SourceLost`
    exactly where the legacy executor raises `CrcMismatch`, so the
    recovery ladder's demote-and-replan loop drives both paths."""

    def __init__(self, plan, source, sink, *, verify: bool,
                 cfg: SchedConfig, stats) -> None:
        from .loader import LoadStats   # lazy: avoid import cycle
        self.plan = plan
        self.source = source
        self.sink = sink
        self.verify = verify
        self.cfg = cfg
        self.st = stats if stats is not None else LoadStats()
        self.n = plan.n
        self.bs = raim5.block_size(plan.total_bytes, plan.n) \
            if plan.n > 1 else 0
        self.own_bytes = (plan.total_bytes if plan.n == 1
                          else (plan.n - 1) * self.bs)
        self.kind = getattr(source, "kind", "")
        self.bw = SourceBandwidth(cfg.ewma_alpha, cfg.priors)

        self.cond = named_condition("readsched.sched")
        self.error: Optional[BaseException] = None
        self.chunks: List[_Chunk] = []
        self.queues: Dict[int, deque] = {}        # node -> deque of cids
        self.pending_bytes: Dict[int, int] = {}
        self.inflight: Dict[int, int] = {}
        self.direct_left = 0
        self.writes_out = 0
        self.decode_q: deque = deque()            # (ref, o1, o2, g, origin)
        self.decode_inflight = 0
        self.rerouted: Optional[int] = None
        self.hedges_issued = 0
        self._tokens: Dict[int, List[CancelToken]] = {}
        self._parity_ok: set = set()
        self._parity_lock = named_lock("readsched.parity")
        # timing attribution (perf_counter stamps)
        self.t0 = 0.0
        self.t_read_end = 0.0
        self.d_start = float("inf")
        self.d_end = 0.0
        # verify bookkeeping
        self.expected: Dict[int, Any] = {}        # node -> crc_own | None
        self.vfull_nodes: set = set()
        self.node_chunks: Dict[int, List[_Chunk]] = {}
        self.node_left: Dict[int, int] = {}       # direct chunks not DONE
        self.block_chunks: Dict[int, Dict[int, List[_Chunk]]] = {}
        self.block_left: Dict[int, Dict[int, int]] = {}
        self.stripe_crcs: Dict[int, List[int]] = {}   # rerouted-node tables

    def _bwkey(self, node: int) -> str:
        return f"{self.kind}:{node}"

    # ------------------------------------------------------------ prepare
    def _prepare(self) -> None:
        from .loader import CrcMismatch, _META_BAD, stripe_table
        plan = self.plan
        if self.verify:
            for node in plan.reads:
                try:
                    self.expected[node] = self.source.meta(node).get(
                        "crc_own")
                except Exception:
                    # unreadable meta = untrustworthy member: demote like a
                    # digest mismatch, same as the legacy read path
                    raise CrcMismatch(
                        node, reason=f"node {node} snapshot meta unreadable")
        cid = 0
        for node in sorted(plan.reads):
            reqs = plan.reads[node]
            expect = self.expected.get(node)
            vfull = (self.verify and expect is not None
                     and plan.member_covered(node))
            chunks: List[_Chunk] = []
            if vfull:
                self.vfull_nodes.add(node)
                chunks = self._tile_full(node, reqs, cid)
            else:
                chunks = self._tile_gather(node, reqs, cid)
            cid += len(chunks)
            self.chunks.extend(chunks)
            self.node_chunks[node] = chunks
            self.node_left[node] = len(chunks)
            self.queues[node] = deque(c.cid for c in chunks)
            self.pending_bytes[node] = sum(c.nbytes for c in chunks)
            self.inflight[node] = 0
            self.direct_left += len(chunks)
            if self.n > 1:
                per_blk: Dict[int, List[_Chunk]] = {}
                for c in chunks:
                    per_blk.setdefault(c.block, []).append(c)
                self.block_chunks[node] = per_blk
                self.block_left[node] = {b: len(cs)
                                         for b, cs in per_blk.items()}
        # planned decode (failed member) -> chunk-sized pipeline items
        step = max(1, self.cfg.chunk_bytes)
        for ref, subs in plan.decode:
            g_base = ref.byte_range(self.bs, self.n)[0]
            for o1, o2 in subs:
                for a in range(o1, o2, step):
                    b = min(a + step, o2)
                    self.decode_q.append((ref, a, b, g_base + a, "plan"))
        # parity-alternative routing preconditions (fixed for the run)
        self.can_reroute = (
            self.cfg.mode == "adaptive"
            and plan.failed is None
            and self.n > 1
            and set(plan.reads) == set(range(self.n))
            and not hasattr(self.source, "locate_spans"))  # chains overlay
        if self.can_reroute:
            for node in plan.reads:
                if node not in self.vfull_nodes:
                    continue
                try:
                    table = stripe_table(self.source.meta(node))
                except Exception:
                    table = None
                # the digest table (seg == block) is what lets a rerouted
                # member's directly-read blocks still be verified
                if table is not None and table[0] == self.bs:
                    self.stripe_crcs[node] = table[1]

    def _tile_full(self, node: int, reqs, cid0: int) -> List[_Chunk]:
        """Contiguous chunks tiling the FULL own region [0, own_bytes)
        (incl. tail padding the engine checksummed), block-aligned so a
        chunk never crosses a RAIM5 block boundary."""
        cb = max(1, self.cfg.chunk_bytes)
        out: List[_Chunk] = []
        ri = 0
        bounds = ([(0, self.own_bytes)] if self.n == 1 else
                  [(li * self.bs, (li + 1) * self.bs)
                   for li in range(self.n - 1)])
        for li, (blo, bhi) in enumerate(bounds):
            for lo in range(blo, bhi, cb):
                hi = min(lo + cb, bhi)
                pieces = []
                while ri < len(reqs) and reqs[ri].local_lo < hi:
                    r = reqs[ri]
                    a, b = max(r.local_lo, lo), min(r.local_hi, hi)
                    if b > a:
                        pieces.append((a, b, r.global_lo + (a - r.local_lo)))
                    if r.local_hi <= hi:
                        ri += 1
                    else:
                        break
                out.append(_Chunk(cid0 + len(out), node, lo, hi,
                                  tuple(pieces), True, li, hi - lo))
        return out

    def _tile_gather(self, node: int, reqs, cid0: int) -> List[_Chunk]:
        """Chunks over exactly the needed local ranges (partial plans /
        unverified members): block-aligned splits, packed up to
        chunk_bytes / 256 pieces per chunk within one block."""
        cb = max(1, self.cfg.chunk_bytes)
        segs: List[Tuple[int, int, int, int]] = []     # (a, b, g, block)
        for r in reqs:
            a = r.local_lo
            while a < r.local_hi:
                li = a // self.bs if self.n > 1 else 0
                cut = (li + 1) * self.bs if self.n > 1 else r.local_hi
                b = min(r.local_hi, cut, a + cb)
                segs.append((a, b, r.global_lo + (a - r.local_lo), li))
                a = b
        out: List[_Chunk] = []
        i = 0
        while i < len(segs):
            blk = segs[i][3]
            pieces = []
            acc = 0
            while (i < len(segs) and segs[i][3] == blk
                   and acc < cb and len(pieces) < 256):
                a, b, g, _ = segs[i]
                pieces.append((a, b, g))
                acc += b - a
                i += 1
            out.append(_Chunk(cid0 + len(out), node, pieces[0][0],
                              pieces[-1][1], tuple(pieces), False, blk, acc))
        return out

    # ---------------------------------------------------------- scheduling
    def _set_error(self, e: BaseException) -> None:
        from .loader import CrcMismatch
        # CrcMismatch beats secondaries: a concurrent member's transient
        # read error must not mask the demote-and-replan signal
        if self.error is None or (isinstance(e, CrcMismatch)
                                  and not isinstance(self.error,
                                                     CrcMismatch)):
            self.error = e

    def _pop_node(self, node: int) -> Optional[_Chunk]:
        q = self.queues.get(node)
        if not q or self.inflight[node] >= self.cfg.inflight_per_source:
            return None
        while q:
            c = self.chunks[q.popleft()]
            if c.state != _PENDING:
                continue                     # rerouted while queued
            c.state = _RUNNING
            c.t_start = time.perf_counter()
            self.inflight[node] += 1
            self.pending_bytes[node] -= c.nbytes
            return c
        return None

    def _estimate(self, node: int, fallback: float) -> float:
        bw = self.bw.bandwidth(self._bwkey(node))
        return bw if bw and bw > 0 else fallback

    def _median_bw(self) -> float:
        vals = sorted(v for v in self.bw.snapshot().values() if v > 0)
        if not vals:
            return 0.0
        return vals[len(vals) // 2]

    def _steal_victim(self, home: int) -> Optional[int]:
        fb = self._median_bw() or 1.0
        best, best_eta = None, 0.0
        for node, q in self.queues.items():
            if node == home or not q:
                continue
            if self.inflight[node] >= self.cfg.inflight_per_source:
                continue
            if self.pending_bytes[node] <= 0:
                continue
            eta = self.pending_bytes[node] / self._estimate(node, fb)
            if best is None or eta > best_eta:
                best, best_eta = node, eta
        return best

    def _all_done(self) -> bool:
        return (self.direct_left == 0 and not self.decode_q
                and self.decode_inflight == 0 and self.writes_out == 0)

    def _next(self, wid: int, home: int):
        with self.cond:
            while True:
                if self.error is not None:
                    return None
                if self.decode_q:
                    item = self.decode_q.popleft()
                    self.decode_inflight += 1
                    return ("decode", item)
                c = self._pop_node(home)
                if c is not None:
                    return ("chunk", c)
                victim = self._steal_victim(home)
                if victim is not None:
                    c = self._pop_node(victim)
                    if c is not None:
                        self.st.stolen_chunks += 1
                        return ("chunk", c)
                if self.cfg.mode == "adaptive":
                    self._maybe_reroute()
                    if self.decode_q:
                        continue
                    h = self._hedge_candidate()
                    if h is not None:
                        h.hedges += 1
                        self.hedges_issued += 1
                        self.st.hedged_reads += 1
                        return ("hedge", h)
                if self._all_done():
                    self.cond.notify_all()
                    return None
                self.cond.wait(0.05)

    def _hedge_candidate(self) -> Optional[_Chunk]:
        if self.hedges_issued >= self.cfg.max_hedges:
            return None
        fb = self._median_bw()
        if fb <= 0:
            return None
        now = time.perf_counter()
        for c in self.chunks:
            if c.state != _RUNNING or c.hedges:
                continue
            expect = c.nbytes / self._estimate(c.node, fb)
            if now - c.t_start > self.cfg.hedge_factor * max(expect, 1e-4):
                return c
        return None

    # ------------------------------------------------- parity reroute
    def _reroutable(self, node: int) -> bool:
        if not self.can_reroute or self.rerouted not in (None, node):
            return False
        if node in self.vfull_nodes and node not in self.stripe_crcs:
            return False
        return True

    def _maybe_reroute(self) -> None:
        """Cost model, evaluated under the lock: convert a slow-but-alive
        member's queued chunks to decode work when its direct ETA exceeds
        `reroute_factor` x the projected decode cost (max sibling direct
        ETA + amplified sibling/parity read time)."""
        if self.rerouted is not None or not self.can_reroute:
            return
        best, best_eta = None, 0.0
        for node in self.plan.reads:
            if not self._reroutable(node):
                continue
            if self.bw.samples(self._bwkey(node)) < self.cfg.min_samples:
                continue
            pend = self.pending_bytes[node]
            if pend <= 0:
                continue
            bwx = self.bw.bandwidth(self._bwkey(node))
            if not bwx or bwx <= 0:
                continue
            fb = self._median_bw() or bwx
            # noise guards: decode amplifies reads (n-1)x and spends the
            # single-parity budget, so only a member persistently well
            # below the fleet median AND with a macroscopic remaining ETA
            # is worth rerouting — one jittery microsecond-scale chunk
            # timing must never trigger it
            if bwx >= 0.5 * fb:
                continue
            eta_direct = pend / bwx
            if eta_direct < self.cfg.min_eta_s:
                continue
            others = [m for m in self.plan.reads if m != node]
            sum_bw = sum(self._estimate(m, fb) for m in others)
            if sum_bw <= 0:
                continue
            eta_others = max((self.pending_bytes[m]
                              / self._estimate(m, fb)) for m in others)
            # decode reads (n-1) bytes (siblings + parity) per rebuilt byte
            eta_reroute = eta_others + pend * (self.n - 1) / sum_bw
            if eta_direct > self.cfg.reroute_factor * max(eta_reroute, 1e-9):
                if best is None or eta_direct > best_eta:
                    best, best_eta = node, eta_direct
        if best is not None:
            self._do_reroute(best)

    def _do_reroute(self, node: int) -> bool:
        """Convert `node`'s PENDING chunks into decode items (under the
        lock).  Verify-streamed members convert at whole-block
        granularity: blocks with DONE/RUNNING chunks stay direct
        ("sticky") and are verified per-block against the stripe digest
        table; all-PENDING blocks become decode work.  Unverified members
        convert pending chunks piecewise.  Returns True if anything
        converted (or the member had nothing pending)."""
        self.rerouted = node
        self.st.rerouted_members = tuple(
            sorted(set(self.st.rerouted_members) | {node}))
        refs = raim5.data_blocks_of_node(node, self.n)
        converted = 0
        if node in self.vfull_nodes:
            for li, cs in self.block_chunks[node].items():
                states = {c.state for c in cs}
                if states <= {_PENDING, _REROUTED}:
                    for c in cs:
                        if c.state == _PENDING:
                            self._convert_chunk(c, refs[li])
                            converted += 1
                elif _DONE in states and self.block_left[node][li] == 0:
                    self._check_block_digest(node, li)
        else:
            for c in self.node_chunks[node]:
                if c.state == _PENDING:
                    self._convert_chunk(c, refs[c.block])
                    converted += 1
        self.cond.notify_all()
        return converted > 0

    def _convert_chunk(self, c: _Chunk, ref) -> None:
        """PENDING direct chunk -> decode items for exactly its pieces."""
        li = c.block
        c.state = _REROUTED
        self.direct_left -= 1
        self.node_left[c.node] -= 1
        self.pending_bytes[c.node] -= c.nbytes
        if self.n > 1:
            self.block_left[c.node][li] -= 1
        for a, b, g in c.pieces:
            o1, o2 = a - li * self.bs, b - li * self.bs
            self.decode_q.append((ref, o1, o2, g, "reroute"))

    def _check_block_digest(self, node: int, li: int) -> None:
        """Fold a completed sticky block's chunk CRCs against the member's
        per-stripe digest table (rerouted members can't fold the whole
        own-region crc_own — decoded blocks were never read)."""
        from .loader import CrcMismatch
        crcs = self.stripe_crcs.get(node)
        if crcs is None:
            return
        cs = sorted(self.block_chunks[node][li], key=lambda c: c.lo)
        crc = 0
        for c in cs:
            crc = crc32_combine(crc, c.crc, c.hi - c.lo)
        if li >= len(crcs) or (crc & 0xFFFFFFFF) != (crcs[li] & 0xFFFFFFFF):
            expect = crcs[li] if li < len(crcs) else 0
            self._set_error(CrcMismatch(
                node, expect, crc,
                reason=f"node {node} block {li} digest mismatch"))

    def _check_node_crc(self, node: int) -> None:
        """All direct chunks of a verify-streamed member landed: fold the
        per-chunk CRCs in offset order against the recorded crc_own."""
        from .loader import CrcMismatch
        expect = self.expected.get(node)
        cs = sorted(self.node_chunks[node], key=lambda c: c.lo)
        crc = 0
        for c in cs:
            crc = crc32_combine(crc, c.crc, c.hi - c.lo)
        if (crc & 0xFFFFFFFF) != (expect & 0xFFFFFFFF):
            self._set_error(CrcMismatch(node, expect, crc))
            return
        self.st.crc_members += (node,)

    # ------------------------------------------------------------- reading
    def _sub_bytes(self) -> int:
        return max(1, min(self.cfg.chunk_bytes,
                          max(self.cfg.chunk_bytes // 4, 1 << 18)))

    def _read_chunk(self, c: _Chunk, token: CancelToken):
        """Pull a chunk's bytes (cancellable between sub-reads).  Returns
        (writes, crc, nbytes, seconds) or None when cancelled."""
        t0 = time.perf_counter()
        writes: List[Tuple[int, np.ndarray]] = []
        crc = 0
        nbytes = 0
        if c.vfull:
            parts: List[Tuple[int, np.ndarray]] = []
            sub = self._sub_bytes()
            pos = c.lo
            while pos < c.hi:
                if token.cancelled:
                    return None
                e = min(pos + sub, c.hi)
                data = self.source.read_local(c.node, pos, e)
                crc = zlib.crc32(data, crc)
                nbytes += data.nbytes
                parts.append((pos, data))
                pos = e
            for a, b, g in c.pieces:
                for plo, arr in parts:
                    s, e = max(a, plo), min(b, plo + arr.nbytes)
                    if e > s:
                        writes.append((g + (s - a), arr[s - plo:e - plo]))
        else:
            batched = getattr(self.source, "read_local_ranges", None)
            if batched is not None:
                if token.cancelled:
                    return None
                datas = batched(c.node, [(a, b) for a, b, _ in c.pieces])
                for (a, b, g), data in zip(c.pieces, datas):
                    nbytes += data.nbytes
                    writes.append((g, data))
            else:
                for a, b, g in c.pieces:
                    if token.cancelled:
                        return None
                    data = self.source.read_local(c.node, a, b)
                    nbytes += data.nbytes
                    writes.append((g, data))
        dt = time.perf_counter() - t0
        self.bw.observe(self._bwkey(c.node), nbytes, dt)
        return writes, crc, nbytes, dt

    def _do_read(self, c: _Chunk, hedge: bool) -> None:
        token = CancelToken()
        with self.cond:
            if c.state != _RUNNING:
                return                       # resolved before we started
            self._tokens.setdefault(c.cid, []).append(token)
        try:
            res = self._read_chunk(c, token)
        except Exception as e:
            with self.cond:
                toks = self._tokens.get(c.cid)
                if toks and token in toks:
                    toks.remove(token)
                if not hedge:
                    self._on_read_error(c, e)
                self.cond.notify_all()
            return
        won = False
        with self.cond:
            toks = self._tokens.get(c.cid)
            if toks and token in toks:
                toks.remove(token)
            if res is not None:
                self.st.bytes_read += res[2]
            if res is not None and c.state == _RUNNING:
                c.state = _DONE
                c.crc = res[1]
                for t in self._tokens.pop(c.cid, ()):
                    t.cancelled = True
                self.direct_left -= 1
                self.inflight[c.node] -= 1
                self.writes_out += 1
                self.t_read_end = max(self.t_read_end,
                                      time.perf_counter())
                if hedge:
                    self.st.hedged_wins += 1
                won = True
        if not won:
            return
        for g, data in res[0]:
            self.sink.write(g, data)
        with self.cond:
            self.writes_out -= 1
            self._after_chunk_done(c)
            self.cond.notify_all()

    def _after_chunk_done(self, c: _Chunk) -> None:
        node = c.node
        self.node_left[node] -= 1
        if self.n > 1:
            self.block_left[node][c.block] -= 1
        if node in self.vfull_nodes:
            if self.rerouted == node:
                if self.block_left[node][c.block] == 0:
                    self._check_block_digest(node, c.block)
            elif self.node_left[node] == 0:
                self._check_node_crc(node)
        if self.cfg.mode == "adaptive" and self.error is None:
            self._maybe_reroute()

    def _on_read_error(self, c: _Chunk, e: Exception) -> None:
        """A direct read died (source gone mid-restore).  Under the lock:
        try to convert the member's remaining chunks to parity decode
        in place; if the conversion isn't clean (no parity budget, no
        digest table, or a partially-landed block that can no longer be
        verified), surface `SourceLost` so the ladder demotes + replans."""
        node = c.node
        if c.state != _RUNNING:
            return                     # a hedge already claimed the chunk
        # the erroring chunk leaves RUNNING either way
        c.state = _PENDING
        c.t_start = 0.0
        self.inflight[node] -= 1
        self.pending_bytes[node] += c.nbytes
        self.queues[node].appendleft(c.cid)
        for t in self._tokens.pop(c.cid, ()):
            t.cancelled = True
        if not self._reroutable(node):
            self._set_error(SourceLost(node, f"node {node} read failed "
                                             f"mid-restore: {e}"))
            return
        if node in self.vfull_nodes:
            # a block with landed-but-unverifiable bytes blocks conversion:
            # its DONE chunks' digests can only be checked once the whole
            # block is read, and the rest of it would now come from parity
            for li, cs in self.block_chunks[node].items():
                states = {x.state for x in cs}
                if _DONE in states and states != {_DONE}:
                    self._set_error(SourceLost(
                        node, f"node {node} died mid-block {li}: "
                              f"landed bytes unverifiable"))
                    return
        self.bw.mark_dead(self._bwkey(node))
        self._do_reroute(node)

    # -------------------------------------------------------------- decode
    def _ensure_parity_verified(self, stripe: int) -> None:
        """Verify the feeding stripe's parity digest once (a corrupt
        survivor parity block would XOR silently into the output)."""
        from .loader import CrcMismatch, stream_crc
        if not self.verify:
            return
        with self._parity_lock:
            if stripe in self._parity_ok:
                return
            try:
                expect = self.source.meta(stripe).get("crc_parity")
            except Exception:
                expect = None              # meta-bad members are demoted
            if expect is not None:         # by the read path / probe
                crc = stream_crc(
                    lambda lo, hi: self.source.read_parity_range(
                        stripe, lo, hi),
                    self.bs, self.cfg.chunk_bytes)
                with self.cond:
                    self.st.bytes_read += self.bs
                if (crc & 0xFFFFFFFF) != (expect & 0xFFFFFFFF):
                    raise CrcMismatch(
                        stripe,
                        reason=f"node {stripe} parity region CRC mismatch "
                               f"(expect {expect:#010x}, got {crc:#010x})")
            self._parity_ok.add(stripe)

    def _do_decode(self, item) -> None:
        ref, o1, o2, g, origin = item
        avoid = (self.plan.failed if origin == "plan" else self.rerouted)
        d0 = time.perf_counter()
        nread = 0
        cur: Optional[int] = None
        try:
            self._ensure_parity_verified(ref.stripe)
            parts = []
            for j in range(self.n - 1):
                if j == ref.index:
                    continue
                nd = raim5.node_of_block(ref.stripe, j, self.n)
                assert nd != avoid
                cur = nd
                t0 = time.perf_counter()
                data = self.source.read_block_range(nd, ref.stripe, j,
                                                    o1, o2)
                self.bw.observe(self._bwkey(nd), data.nbytes,
                                time.perf_counter() - t0)
                nread += data.nbytes
                parts.append(data)
            cur = ref.stripe
            t0 = time.perf_counter()
            parity = self.source.read_parity_range(ref.stripe, o1, o2)
            self.bw.observe(self._bwkey(ref.stripe), parity.nbytes,
                            time.perf_counter() - t0)
            nread += parity.nbytes
            parts.append(parity)
            cur = None
            out = raim5.xor_blocks(parts)
            self.sink.write(g, out)
        except Exception as e:
            from .loader import CrcMismatch
            with self.cond:
                self.decode_inflight -= 1
                self.st.bytes_read += nread
                if isinstance(e, CrcMismatch):
                    self._set_error(e)
                elif cur is not None:
                    self._set_error(SourceLost(
                        cur, f"decode input node {cur} read failed: {e}"))
                else:
                    self._set_error(e)
                self.cond.notify_all()
            return
        d1 = time.perf_counter()
        with self.cond:
            self.decode_inflight -= 1
            self.st.bytes_read += nread
            if origin == "plan":
                self.st.decoded_bytes += o2 - o1
            else:
                self.st.parity_rerouted_bytes += o2 - o1
            self.d_start = min(self.d_start, d0)
            self.d_end = max(self.d_end, d1)
            self.cond.notify_all()

    # ----------------------------------------------------------------- run
    def _worker(self, wid: int, home: int) -> None:
        try:
            while True:
                item = self._next(wid, home)
                if item is None:
                    return
                kind, obj = item
                if kind == "decode":
                    self._do_decode(obj)
                else:
                    self._do_read(obj, hedge=(kind == "hedge"))
        except BaseException as e:      # pragma: no cover - internal bug
            with self.cond:
                self._set_error(e)
                self.cond.notify_all()

    def run(self):
        from concurrent.futures import ThreadPoolExecutor

        st = self.st
        st.source = st.source or self.kind
        st.saved_n = self.plan.n
        st.bytes_needed = self.plan.bytes_needed
        st.members = tuple(sorted(self.plan.reads))
        st.sched = self.cfg.mode
        if self.verify:
            st.crc_members = ()
        t_wall = time.perf_counter()
        self._prepare()
        nodes = sorted(self.plan.reads) or [0]
        nw = self.cfg.workers or min(8, max(1, len(self.plan.reads) + 1))
        st.parallel_readers = nw
        self.t0 = time.perf_counter()
        if nw == 1:
            self._worker(0, nodes[0])
        else:
            with ThreadPoolExecutor(max_workers=nw) as pool:
                futs = [pool.submit(self._worker, i, nodes[i % len(nodes)])
                        for i in range(nw)]
                for f in futs:
                    f.result()
        if self.error is not None:
            raise self.error
        # consistent phase attribution: read span, decode span, overlap
        r_end = self.t_read_end if self.t_read_end else self.t0
        st.read_seconds += r_end - self.t0
        if self.d_end:
            st.decode_seconds += self.d_end - self.d_start
            st.overlap_seconds += max(
                0.0, min(r_end, self.d_end) - max(self.t0, self.d_start))
        st.crc_members = tuple(sorted(set(st.crc_members)))
        for k, v in self.bw.snapshot().items():
            st.source_bandwidth[k] = v
        st.wall_seconds += time.perf_counter() - t_wall
        return st


__all__ = [
    "SchedConfig", "SourceBandwidth", "CancelToken", "SourceLost",
    "ThrottledSource", "BucketedSource", "ChunkScheduler",
]
