"""Object-store abstraction for the tier-4 durable rung.

The recovery ladder's durable story used to end at local `.reft` files
(tier 3): one node-local disk loss below the in-memory tiers and the
family was gone.  `ObjectStore` is the minimal remote-tier contract the
rest of the stack programs against:

  put_part / compose   multipart upload — the SMP's persist worker
                       streams one part per RAIM5 stripe, then composes
                       the final object (no staging copy, no torn
                       objects: the composed key appears atomically);
  read_range           positioned reads — restore plans (`LoadPlan`)
                       pull exactly the stripe sub-ranges they need;
  list / delete        discovery + retention (manifest listing, GC).

Implementations: `LocalObjectStore` (filesystem-backed, tests/CI) and
`FlakyStore` (an injectable wrapper simulating latency, throttling, and
transient 5xx-style errors to exercise retry-with-backoff).

Errors are split into `TransientStoreError` (throttle/5xx analogue —
retryable, `transient = True`) and terminal `StoreError`s; callers that
must survive a flaky remote wrap operations in `call_with_retries`
(bounded exponential backoff).  Stores are constructed from plain config
dicts via `store_from_config` so the SMP child process — a separate OS
process that only ever sees pickled persist messages — can build its own
instance on the far side of the pipe.
"""
from __future__ import annotations

import abc
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np


class StoreError(RuntimeError):
    """Terminal object-store failure (bad key, malformed compose, ...)."""


class NotFoundError(StoreError):
    """The requested key does not exist."""


class TransientStoreError(StoreError):
    """Retryable failure (throttling / 5xx analogue).  The `transient`
    class attribute lets modules that must not import this package (the
    loader's `ObjectSource` sits below it) detect retryability with
    `getattr(err, "transient", False)`."""

    transient = True


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for transient store errors."""
    attempts: int = 5           # total tries (1 = no retry)
    base_s: float = 0.05        # first backoff
    max_s: float = 2.0          # backoff cap
    mult: float = 2.0


def retry_policy(cfg) -> RetryPolicy:
    """RetryPolicy from a plain dict (persist messages / spec.options),
    an existing policy, or None (defaults)."""
    if cfg is None:
        return RetryPolicy()
    if isinstance(cfg, RetryPolicy):
        return cfg
    return RetryPolicy(
        attempts=int(cfg.get("attempts", 5)),
        base_s=float(cfg.get("base_s", 0.05)),
        max_s=float(cfg.get("max_s", 2.0)),
        mult=float(cfg.get("mult", 2.0)))


def call_with_retries(fn: Callable[[], object],
                      policy: Optional[RetryPolicy] = None,
                      sleep: Callable[[float], None] = time.sleep
                      ) -> Tuple[object, int]:
    """Run `fn`, retrying `TransientStoreError` with bounded exponential
    backoff.  Returns (result, retries_used); terminal errors — and a
    transient error on the last attempt — propagate."""
    pol = policy or RetryPolicy()
    attempts = max(1, pol.attempts)
    delay = pol.base_s
    for i in range(attempts):
        try:
            return fn(), i
        except TransientStoreError:
            if i + 1 >= attempts:
                raise
            sleep(delay)
            delay = min(pol.max_s, delay * pol.mult)
    raise AssertionError("unreachable")


def retrier(retry_cfg) -> Callable[[Callable[[], object]], object]:
    """A `call -> result` wrapper the loader's `ObjectSource` takes: it
    never imports this package, so recovery hands it a closure instead."""
    pol = retry_policy(retry_cfg)
    return lambda fn: call_with_retries(fn, pol)[0]


class ObjectStore(abc.ABC):
    """Minimal object-store protocol (see module docstring).  Keys are
    `/`-separated paths; objects are immutable once composed."""

    kind: str = "abstract"

    # ------------------------------------------------------------ write
    @abc.abstractmethod
    def put_part(self, key: str, part: int, data) -> None:
        """Upload part `part` (0-based) of the object at `key`.  Parts
        are invisible until `compose`."""

    @abc.abstractmethod
    def compose(self, key: str, nparts: int) -> int:
        """Assemble parts 0..nparts-1 into the final object (atomic:
        readers see either the old object or the complete new one, never
        a prefix).  Returns the object size; the parts are consumed."""

    def put(self, key: str, data) -> None:
        """Single-shot object write (manifests, small blobs)."""
        self.put_part(key, 0, data)
        self.compose(key, 1)

    # ------------------------------------------------------------- read
    @abc.abstractmethod
    def read_range(self, key: str, lo: int, hi: int) -> np.ndarray:
        """Bytes [lo, hi) of the object as a uint8 array."""

    @abc.abstractmethod
    def size(self, key: str) -> int:
        """Object size in bytes; raises `NotFoundError` when absent."""

    def read(self, key: str) -> bytes:
        return bytes(self.read_range(key, 0, self.size(key)))

    def exists(self, key: str) -> bool:
        try:
            self.size(key)
            return True
        except NotFoundError:
            return False

    # -------------------------------------------------- listing / admin
    @abc.abstractmethod
    def list(self, prefix: str = "") -> List[str]:
        """Sorted keys of composed objects under `prefix` (parts and
        scratch are never listed)."""

    @abc.abstractmethod
    def delete(self, key: str) -> None:
        """Remove one object (idempotent: absent keys are a no-op)."""

    def delete_prefix(self, prefix: str) -> int:
        """Remove every object under `prefix`; returns the count."""
        n = 0
        for key in self.list(prefix):
            self.delete(key)
            n += 1
        return n

    @property
    @abc.abstractmethod
    def config(self) -> dict:
        """A plain picklable dict `store_from_config` rebuilds this store
        from — the form persist messages carry across the SMP pipe."""


def store_from_config(cfg) -> "ObjectStore":
    """Construct a store from its config dict (or pass an instance
    through).  The factory every process boundary routes through."""
    if isinstance(cfg, ObjectStore):
        return cfg
    if not isinstance(cfg, dict):
        raise StoreError(f"bad store config {cfg!r}")
    kind = cfg.get("kind")
    if kind == "local":
        from repro_torch.store.local import LocalObjectStore
        return LocalObjectStore(cfg["root"])
    if kind == "flaky":
        from repro_torch.store.flaky import FlakyStore
        inner = store_from_config(cfg["inner"])
        return FlakyStore(
            inner,
            latency_s=float(cfg.get("latency_s", 0.0)),
            error_rate=float(cfg.get("error_rate", 0.0)),
            fail_every=int(cfg.get("fail_every", 0)),
            seed=int(cfg.get("seed", 0)))
    raise StoreError(f"unknown store kind {kind!r}")
