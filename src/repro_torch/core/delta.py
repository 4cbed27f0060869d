"""Dirty-delta snapshot planning: pay for what changed, not model size.

An MoE training step touches only the experts its router selected, and
optimizer moments for cold leaves are bit-identical across adjacent
flights — yet every HASC flight copies every byte.  This module plans
*delta flights*: a flight that re-sends only the buckets that may have
changed since the previous published snapshot (the *base*), with the SMP
seeding the new shard buffer from the base so untouched bytes carry over.

Two independent dirtiness signals compose:

  * a *provider* (e.g. the MoE router's touched-expert mask, mapped to
    global byte ranges by `expert_dirty_ranges`) rules buckets clean
    BEFORE any read — the L1 pump never prefetches or copies them
    to the host; and
  * a *digest compare* (per-bucket CRC32 vs the previous flight's
    table — the device path reuses the CUDA encode kernel, so only the
    4-byte digest crosses d2h for a clean bucket) catches bit-identical
    buckets inside nominally-dirty ranges.

`DeltaTracker` owns the policy: it keeps the previous flight's digest
table, refuses a delta when the base is not the SMP's latest clean step,
and forces a full keyframe every `keyframe_every` flights or when the
dirty fraction exceeds `dirty_threshold` (delta saves nothing dense).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

Range = Tuple[int, int]

# leaves whose leading dim is the expert axis (params and their optimizer
# moments share path suffixes)
EXPERT_LEAF_MARKERS = ("wi_gate", "wi_up", "wo", "expert")


# ------------------------------------------------------------- ranges
def merge_ranges(ranges: Sequence[Range]) -> List[Range]:
    """Sort + coalesce (lo, hi) byte ranges; drops empties."""
    out: List[Range] = []
    for lo, hi in sorted((int(a), int(b)) for a, b in ranges):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out

def ranges_bytes(ranges: Sequence[Range]) -> int:
    return sum(hi - lo for lo, hi in ranges)


def ranges_intersect(ranges: Sequence[Range], lo: int, hi: int) -> bool:
    """True iff [lo, hi) overlaps any of the MERGED, SORTED `ranges`."""
    if hi <= lo or not ranges:
        return False
    i = bisect.bisect_right([r[0] for r in ranges], lo)
    if i and ranges[i - 1][1] > lo:
        return True
    return i < len(ranges) and ranges[i][0] < hi


def task_dirty(task, ranges: Sequence[Range]) -> bool:
    """Does a `BucketTask` touch any dirty global byte range?  Own-data
    buckets check their own span; fused parity buckets check every
    source block slice (parity must refresh when ANY sibling moved)."""
    if task.kind == 2 and task.sources:
        return any(ranges_intersect(ranges, a, b) for a, b in task.sources)
    return ranges_intersect(ranges, task.lo, task.hi)


def expert_dirty_ranges(spec, touched: Sequence[bool],
                        markers: Sequence[str] = EXPERT_LEAF_MARKERS
                        ) -> List[Range]:
    """Touched-expert mask -> conservative global dirty byte ranges.

    Expert-stacked leaves (leading dim == len(touched), path naming an
    expert weight, not under `blocks`) contribute only their touched
    experts' slices; every other leaf (router, norms, embeddings,
    scalars — all updated every step) is whole-leaf dirty. A leaf under
    `blocks` carries the stack of periods first, (n_periods, E, ...), so
    it is always whole-leaf dirty, whatever its shape: the reference
    takes its leading dim for the experts' when n_periods == E, and rules
    an untouched expert's slices of period 0 clean while every period's
    changed. (AdamW's decay
    and momentum change every expert's bytes every step anyway.)"""
    E = len(touched)
    out: List[Range] = []
    for leaf in spec.leaves:
        stacked = (E > 1 and len(leaf.shape) >= 1 and leaf.shape[0] == E
                   and leaf.nbytes % E == 0
                   and "['blocks']" not in leaf.path
                   and any(m in leaf.path for m in markers))
        if not stacked:
            out.append((leaf.offset, leaf.offset + leaf.nbytes))
            continue
        per = leaf.nbytes // E
        for e in range(E):
            if touched[e]:
                out.append((leaf.offset + e * per,
                            leaf.offset + (e + 1) * per))
    return merge_ranges(out)


# ------------------------------------------------------------- planning
@dataclass(frozen=True)
class FlightDelta:
    """One delta flight's plan, handed to `PipelineFlight`.

    `base_step` must be the SMP's latest clean step (the buffer the SMP
    seeds the new shard from); `prev` maps full-schedule task index ->
    that base flight's bucket CRC32; `skip` are task indices ruled clean
    by the provider (never read); `digest` enables the per-bucket
    digest-compare skip for the rest."""
    base_step: int
    prev: Dict[int, int]
    skip: FrozenSet[int] = frozenset()
    digest: bool = True


@dataclass
class DeltaTracker:
    """Keyframe/delta policy + the previous flight's digest table."""
    keyframe_every: int = 8
    dirty_threshold: float = 0.6
    digest: bool = True
    base_step: int = -1
    digests: Optional[Dict[int, int]] = None
    flights_since_keyframe: int = 0
    force_keyframe: bool = False
    base_misses: int = 0

    def invalidate(self) -> None:
        """Drop the base: the next flight MUST be a keyframe (engine
        degraded/healed, SMP respawned, or a delta-begin base miss)."""
        self.digests = None
        self.base_step = -1

    def plan(self, last_clean_step: int, sched,
             dirty_ranges: Optional[Sequence[Range]],
             total_bytes: int) -> Optional[FlightDelta]:
        """None -> take a full keyframe; else the delta plan."""
        if (self.digests is None or last_clean_step < 0
                or self.base_step != last_clean_step):
            return None
        if self.force_keyframe \
                or self.flights_since_keyframe >= self.keyframe_every:
            return None
        skip: FrozenSet[int] = frozenset()
        if dirty_ranges is not None:
            ranges = merge_ranges(dirty_ranges)
            if ranges_bytes(ranges) > self.dirty_threshold * total_bytes:
                return None
            skip = frozenset(i for i, t in enumerate(sched)
                             if not task_dirty(t, ranges))
        return FlightDelta(self.base_step, dict(self.digests), skip,
                           self.digest)

    def commit(self, clean_step: int, digests: Optional[Dict[int, int]],
               was_delta: bool, sent_frac: float) -> None:
        """Fold a finished flight back in: its digest table becomes the
        next base; a delta that turned out dense forces a keyframe."""
        self.digests = dict(digests) if digests is not None else None
        self.base_step = clean_step if digests is not None else -1
        self.flights_since_keyframe = \
            self.flights_since_keyframe + 1 if was_delta else 0
        self.force_keyframe = was_delta \
            and sent_frac > self.dirty_threshold


# ------------------------------------------------------- persist chains
@dataclass
class DeltaLog:
    """Per-engine record of which buffer-local extents each published
    step rewrote (None => keyframe: the whole shard).  `extents_since`
    answers "what must a `.reftd` persisted at `step` carry relative to
    a base persisted at `base`" — the union over every flight in
    (base, step], or None when the chain is broken (a missing step, a
    keyframe in between, or an unknown base) and the persist must be a
    full `.reft`."""
    cap: int = 128
    entries: Dict[int, Optional[Tuple[Range, ...]]] = field(
        default_factory=dict)

    def record(self, step: int, extents: Optional[Sequence[Range]]) -> None:
        self.entries[int(step)] = (tuple(merge_ranges(extents))
                                   if extents is not None else None)
        while len(self.entries) > self.cap:
            del self.entries[min(self.entries)]

    def extents_since(self, base: int, step: int) -> Optional[List[Range]]:
        if base is None or base < 0 or step <= base \
                or base not in self.entries:
            return None
        acc: List[Range] = []
        for s in range(base + 1, step + 1):
            if s not in self.entries:
                continue                     # step not snapshotted: fine
            ext = self.entries[s]
            if ext is None:                  # keyframe in the span
                return None
            acc.extend(ext)
        if not acc:                          # nothing changed: still emit
            return []                        # an (empty) delta
        return merge_ranges(acc)
