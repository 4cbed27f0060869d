"""Fault-injecting `ObjectStore` wrapper.

Wraps any inner store and perturbs the *data-path* calls (put_part /
compose / put / read_range / read) with configurable latency and
transient 5xx-style failures, so retry-with-backoff paths are exercised
under test without a real unreliable remote.  Faults are deterministic:
`fail_every=k` trips every k-th data-path op (a counter, so a bounded
retry always eventually succeeds), and `error_rate` draws from a seeded
RNG.  Listing/admin calls pass through untouched — fault injection aims
at upload/restore, not discovery.

A fault fires *before* the inner call, so a failed put never partially
lands — matching a rejected-by-throttle request.
"""
from __future__ import annotations

import random
import time
from typing import List

import numpy as np

from repro_torch.store.base import ObjectStore, TransientStoreError


class FlakyStore(ObjectStore):
    kind = "flaky"

    def __init__(self, inner: ObjectStore, *, latency_s: float = 0.0,
                 error_rate: float = 0.0, fail_every: int = 0,
                 seed: int = 0):
        self.inner = inner
        self.latency_s = float(latency_s)
        self.error_rate = float(error_rate)
        self.fail_every = int(fail_every)
        self._rng = random.Random(seed)
        self._seed = int(seed)
        self.counts = {"ops": 0, "faults": 0}

    def _perturb(self, op: str) -> None:
        self.counts["ops"] += 1
        if self.latency_s:
            time.sleep(self.latency_s)
        trip = (self.fail_every
                and self.counts["ops"] % self.fail_every == 0)
        if not trip and self.error_rate:
            trip = self._rng.random() < self.error_rate
        if trip:
            self.counts["faults"] += 1
            raise TransientStoreError(
                f"simulated 503 on {op} (op #{self.counts['ops']})")

    # ---------------------------------------------------------- faulted
    def put_part(self, key: str, part: int, data) -> None:
        self._perturb("put_part")
        self.inner.put_part(key, part, data)

    def compose(self, key: str, nparts: int) -> int:
        self._perturb("compose")
        return self.inner.compose(key, nparts)

    def put(self, key: str, data) -> None:
        self._perturb("put")
        self.inner.put(key, data)

    def read_range(self, key: str, lo: int, hi: int) -> np.ndarray:
        self._perturb("read_range")
        return self.inner.read_range(key, lo, hi)

    def read(self, key: str) -> bytes:
        self._perturb("read")
        return self.inner.read(key)

    # ------------------------------------------------------ passthrough
    def size(self, key: str) -> int:
        return self.inner.size(key)

    def exists(self, key: str) -> bool:
        return self.inner.exists(key)

    def list(self, prefix: str = "") -> List[str]:
        return self.inner.list(prefix)

    def delete(self, key: str) -> None:
        self.inner.delete(key)

    def delete_prefix(self, prefix: str) -> int:
        return self.inner.delete_prefix(prefix)

    def write_range(self, key: str, off: int, data) -> None:
        # only when the inner store offers the scrub fast path
        self.inner.write_range(key, off, data)

    @property
    def config(self) -> dict:
        return {"kind": "flaky", "inner": self.inner.config,
                "latency_s": self.latency_s, "error_rate": self.error_rate,
                "fail_every": self.fail_every, "seed": self._seed}
