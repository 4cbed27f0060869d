"""Runtime lock-order checker (repro_torch.analyze part 2).

Concurrency bugs in this repo historically live where many actors
interleave (HASC levels, the SMP persist worker, the read scheduler's
stealing pool).  This module makes the *lock discipline* of those actors
machine-checked: every lock the saving/restore paths create goes through
`named_lock`/`named_rlock`/`named_condition`, which return plain
`threading` primitives when tracing is off (zero overhead) and
instrumented wrappers when a `LockTracer` is installed.

The tracer records, per thread, the stack of named locks currently held;
each acquisition of lock B while A is held adds the edge A -> B to a
global lock-order graph.  Two failure modes are reported:

  * inconsistent order — both A -> B and B -> A observed (the classic
    ABBA deadlock precondition), detected eagerly at the second
    acquisition with sample stacks for BOTH directions;
  * cycles — any longer cycle in the accumulated order graph, found by
    `check()` / `cycles()` at report time.

Edges are keyed by lock *name* (a stable role string like
``"smp.handle.tx"``), not instance, so the discipline generalises across
members and runs; self-edges (two instances of the same role, or RLock
re-entry) are recorded separately and are not violations by default.

The pytest plugin in ``tests/conftest.py`` installs a tracer for the
whole tier-1 run when ``ANALYZE_LOCKGRAPH=1`` (CI does), failing any
test that introduces a violation and dumping the discovered graph to
``ANALYZE_LOCKGRAPH_JSON`` at session end — the tier-1 suite doubles as
the dynamic corpus across pipeline, smp, readsched and supervise.
"""
from __future__ import annotations

import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "LockOrderViolation", "LockTracer", "TracedLock", "TracedCondition",
    "named_lock", "named_rlock", "named_condition", "install", "uninstall",
    "current_tracer",
]


class LockOrderViolation(RuntimeError):
    """An ABBA pair or cycle in the observed lock-order graph."""


def _stack(skip: int = 3) -> str:
    return "".join(traceback.format_stack()[:-skip][-6:])


class LockTracer:
    """Global lock-order graph + per-thread held stacks."""

    def __init__(self, keep_stacks: bool = True):
        self._mu = threading.Lock()           # guards graph bookkeeping
        self._tls = threading.local()
        self.keep_stacks = keep_stacks
        # name -> set of names acquired while `name` was held
        self.edges: Dict[str, Set[str]] = {}
        self.edge_stacks: Dict[Tuple[str, str], str] = {}
        self.locks_seen: Set[str] = set()
        self.self_edges: Set[str] = set()
        self.acquisitions = 0
        self.violations: List[dict] = []

    # ------------------------------------------------------- held stack
    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def push(self, name: str) -> None:
        held = self._held()
        with self._mu:
            self.acquisitions += 1
            self.locks_seen.add(name)
            for h in held:
                if h == name:
                    self.self_edges.add(name)
                    continue
                fresh = name not in self.edges.get(h, ())
                self.edges.setdefault(h, set()).add(name)
                if fresh and self.keep_stacks:
                    self.edge_stacks[(h, name)] = _stack()
                # eager ABBA: the reverse edge already exists
                if fresh and h in self.edges.get(name, ()):
                    self.violations.append({
                        "kind": "inconsistent-order",
                        "pair": (h, name),
                        "stack_forward": self.edge_stacks.get((h, name), ""),
                        "stack_reverse": self.edge_stacks.get((name, h), ""),
                    })
        held.append(name)

    def pop(self, name: str) -> None:
        held = self._held()
        # locks are not always released LIFO (e.g. Condition.wait): drop
        # the newest matching entry
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    # -------------------------------------------------------- reporting
    def cycles(self) -> List[List[str]]:
        """All elementary cycles reachable in the order graph (DFS)."""
        with self._mu:
            graph = {k: sorted(v) for k, v in self.edges.items()}
        out: List[List[str]] = []
        seen_cycles: Set[Tuple[str, ...]] = set()
        color: Dict[str, int] = {}
        path: List[str] = []

        def dfs(u: str) -> None:
            color[u] = 1
            path.append(u)
            for v in graph.get(u, ()):
                if color.get(v, 0) == 1:
                    cyc = path[path.index(v):] + [v]
                    key = tuple(sorted(set(cyc)))
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append(cyc)
                elif color.get(v, 0) == 0:
                    dfs(v)
            path.pop()
            color[u] = 2

        for node in sorted(graph):
            if color.get(node, 0) == 0:
                dfs(node)
        return out

    def check(self) -> None:
        """Raise `LockOrderViolation` on any ABBA pair or cycle."""
        cycs = self.cycles()
        if self.violations or cycs:
            lines = [f"inconsistent order {v['pair'][0]} <-> {v['pair'][1]}"
                     for v in self.violations]
            lines += [" -> ".join(c) for c in cycs]
            raise LockOrderViolation(
                "lock-order violations:\n  " + "\n  ".join(lines))

    def summary(self) -> dict:
        # cycles() takes _mu itself — compute before entering the region
        cycs = [list(c) for c in self.cycles()]
        with self._mu:
            return {
                "locks": sorted(self.locks_seen),
                "edges": sorted((a, b) for a, bs in self.edges.items()
                                for b in bs),
                "self_edges": sorted(self.self_edges),
                "acquisitions": self.acquisitions,
                "violations": [
                    {"kind": v["kind"], "pair": list(v["pair"])}
                    for v in self.violations],
                "cycles": cycs,
            }


class TracedLock:
    """`threading.Lock`/`RLock` wrapper feeding a `LockTracer`."""

    def __init__(self, name: str, tracer: LockTracer, rlock: bool = False):
        self.name = name
        self._tracer = tracer
        self._inner = threading.RLock() if rlock else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._tracer.push(self.name)
        return ok

    def release(self) -> None:
        self._tracer.pop(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class TracedCondition:
    """`threading.Condition` wrapper: `wait` releases the underlying lock,
    so the held record is popped for the duration of the wait — a thread
    blocked in `cond.wait()` holds nothing and must not contribute order
    edges for its wakeup reacquisition's sake."""

    def __init__(self, name: str, tracer: LockTracer):
        self.name = name
        self._tracer = tracer
        self._inner = threading.Condition()

    def acquire(self, *a, **kw) -> bool:
        ok = self._inner.acquire(*a, **kw)
        if ok:
            self._tracer.push(self.name)
        return ok

    def release(self) -> None:
        self._tracer.pop(self.name)
        self._inner.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        self._tracer.pop(self.name)
        try:
            return self._inner.wait(timeout)
        finally:
            self._tracer.push(self.name)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        self._tracer.pop(self.name)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._tracer.push(self.name)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


# ------------------------------------------------------------- factories
_TRACER: Optional[LockTracer] = None


def install(tracer: Optional[LockTracer] = None) -> LockTracer:
    """Install (and return) the process-global tracer.  Locks created
    BEFORE install stay plain — install early (the pytest plugin does it
    at configure time, before any repro module builds a lock)."""
    global _TRACER
    _TRACER = tracer or LockTracer()
    return _TRACER


def uninstall() -> None:
    global _TRACER
    _TRACER = None


def current_tracer() -> Optional[LockTracer]:
    return _TRACER


def named_lock(name: str):
    """A `threading.Lock` under `name` in the lock-order graph; a plain
    lock (zero overhead) when no tracer is installed."""
    if _TRACER is None:
        return threading.Lock()
    return TracedLock(name, _TRACER)


def named_rlock(name: str):
    if _TRACER is None:
        return threading.RLock()
    return TracedLock(name, _TRACER, rlock=True)


def named_condition(name: str):
    if _TRACER is None:
        return threading.Condition()
    return TracedCondition(name, _TRACER)
