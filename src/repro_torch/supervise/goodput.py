"""Goodput ledger: attribute every wall-clock second of a supervised run.

The resiliency literature (and the nemo-gke resiliency recipes) measure
fault-tolerance quality as *goodput*: the fraction of wall clock spent on
forward progress.  Everything else is badput with a cause:

  compute           productive train steps that survived to the end
  lost_steps        steps that ran but were rolled back by a restore
  checkpoint_stall  trainer blocked on snapshot/persist machinery
  detect            failure happened -> supervisor noticed
  restore           recovery ladder + heal + verify
  overhead          supervisor bookkeeping / scenario injection

Attribution is *sequential*: `mark(category)` charges all time since the
previous mark to `category`.  Because every second lands in exactly one
bucket, the per-category sums reconstruct wall clock exactly — which is
what makes the BENCH_goodput.json 5%-sum acceptance check meaningful
rather than vacuous.
"""
from __future__ import annotations

import json
import time

CATEGORIES = ("compute", "lost_steps", "checkpoint_stall",
              "detect", "restore", "overhead")


class GoodputLedger:
    """Sequential wall-clock attribution with an injectable clock."""

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self.seconds = {c: 0.0 for c in CATEGORIES}
        self.events: list[dict] = []
        self._t0 = clock()
        self._last = self._t0
        self._closed_at = None

    def mark(self, category: str) -> float:
        """Charge the interval since the previous mark to `category`.
        Returns the interval length."""
        if category not in self.seconds:
            raise ValueError(f"unknown goodput category {category!r}; "
                             f"want one of {CATEGORIES}")
        now = self.clock()
        dt = now - self._last
        self.seconds[category] += dt
        self._last = now
        return dt

    def transfer(self, frm: str, to: str, seconds: float) -> None:
        """Re-attribute already-charged seconds (e.g. compute that a
        rollback turned into lost_steps).  Conserves the total, so the
        sum-to-wall-clock invariant is untouched."""
        seconds = min(max(seconds, 0.0), self.seconds[frm])
        self.seconds[frm] -= seconds
        self.seconds[to] += seconds

    def record_event(self, **kw) -> None:
        """Append one structured failure/recovery event to the trajectory."""
        kw.setdefault("t", self.clock() - self._t0)
        self.events.append(kw)

    def close(self, category: str = "overhead") -> None:
        """Flush the tail interval so wall == sum(categories)."""
        self.mark(category)
        self._closed_at = self._last     # the mark's own clock reading:
        # a second clock() call here would open a sliver of unaccounted
        # wall between the final mark and the close stamp

    @property
    def wall(self) -> float:
        end = self._closed_at if self._closed_at is not None else self.clock()
        return end - self._t0

    @property
    def accounted(self) -> float:
        return sum(self.seconds.values())

    @property
    def goodput_frac(self) -> float:
        return self.seconds["compute"] / max(self.wall, 1e-9)

    def check(self, tol: float = 0.05) -> bool:
        """Per-category seconds must sum to wall clock within `tol`."""
        wall = self.wall
        return abs(self.accounted - wall) <= tol * max(wall, 1e-9)

    def summary(self) -> dict:
        wall = self.wall
        return {
            "wall_seconds": wall,
            "goodput_frac": self.goodput_frac,
            "seconds": dict(self.seconds),
            "fractions": {c: s / max(wall, 1e-9)
                          for c, s in self.seconds.items()},
            "accounted_seconds": self.accounted,
            "accounting_error": abs(self.accounted - wall) / max(wall, 1e-9),
            "events": list(self.events),
        }

    def dump(self, path: str, extra: dict = None) -> dict:
        payload = self.summary()
        if extra:
            payload.update(extra)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        return payload
