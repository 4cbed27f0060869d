"""Deterministic fault-scenario engine for supervised training runs.

The paper treats failures as routine; this module makes them *injectable*
on demand, mid-flight, and reproducibly.  A `Scenario` names one fault
from the ROADMAP taxonomy:

  software        trainer-process crash (engine marked UNHEALTHY)
  node            whole-node loss (SMP killed + shm segments unlinked)
  smp             dead Snapshot Management Process only (segments survive)
  laggard         member stalls (SIGSTOP, auto-SIGCONT after lag_s)
  corrupt-stripe  bytes flipped inside a live shm snapshot buffer
  slow-persist    latency injected on the durable-tier write path
  preempt         spot reclaim: SIGTERM-style notice, grace_s to drain,
                  then the node is gone

`plan_scenarios(seed, ...)` derives a schedule from a single RNG seed so
every sweep episode, CI smoke, and bug report replays byte-identically
(the same seed gives the JAX package's plan).  Corruption helpers write
real damage — XORing bytes in an attached shm segment or a `.reft` file
past its pickled head — so detection has to be earned by the CRC
machinery, not simulated.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field, replace

import numpy as np

KINDS = ("software", "node", "smp", "laggard", "corrupt-stripe",
         "slow-persist", "preempt")

#: kinds that destroy state and force a restore (vs perf-only faults)
FAILURE_KINDS = frozenset({"software", "node", "smp", "preempt",
                           "corrupt-stripe"})

#: sane small-scale defaults for parameterized kinds (seconds / bytes)
DEFAULT_PARAMS = {
    "laggard": {"lag_s": 0.4},
    "slow-persist": {"delay_s": 0.25},
    "preempt": {"grace_s": 0.3},
    "corrupt-stripe": {"nbytes": 16},
}


@dataclass(frozen=True)
class Scenario:
    """One planned fault: fire `kind` on `node` at training step `step`.
    `graceful=False` means inject mid-flight — no draining of in-flight
    saves first."""
    kind: str
    step: int
    node: int = 0
    graceful: bool = False
    params: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown scenario kind {self.kind!r}; "
                             f"want one of {KINDS}")

    def merged_params(self) -> dict:
        out = dict(DEFAULT_PARAMS.get(self.kind, {}))
        out.update(self.params)
        return out


def parse_scenario(text: str, *, default_node: int = 0) -> Scenario:
    """Parse 'STEP:KIND[:NODE]' (the --inject CLI grammar)."""
    parts = text.split(":")
    if len(parts) not in (2, 3):
        raise ValueError(f"--inject wants STEP:KIND[:NODE] "
                         f"(kind: {'|'.join(KINDS)}), got {text!r}")
    try:
        step = int(parts[0])
    except ValueError:
        raise ValueError(f"--inject STEP must be an int, got {parts[0]!r}")
    kind = parts[1]
    if kind not in KINDS:
        raise ValueError(f"--inject kind must be one of "
                         f"{'|'.join(KINDS)}, got {kind!r}")
    node = int(parts[2]) if len(parts) == 3 else default_node
    return Scenario(kind=kind, step=step, node=node)


def plan_scenarios(seed: int, *, n: int, total_steps: int, count: int,
                   kinds=KINDS, first_step: int = 3,
                   min_gap: int = 2) -> list:
    """Derive a deterministic schedule of `count` scenarios from `seed`.

    Steps are spread over [first_step, total_steps) with at least
    `min_gap` steps between consecutive faults so each one can be healed
    before the next lands; kinds cycle through a seed-shuffled order so
    a small `count` still covers distinct kinds; every non-parametric
    fault targets a seed-chosen node.  Same seed -> same plan, always.
    """
    kinds = tuple(kinds)
    if not kinds:
        raise ValueError("kinds must be non-empty")
    rng = np.random.default_rng(seed)
    span = max(total_steps - first_step, count * min_gap)
    # spread: one fault per equal slice of the run, jittered inside it
    slice_w = span / count
    steps, prev = [], first_step - min_gap
    for i in range(count):
        lo = first_step + int(i * slice_w)
        hi = max(first_step + int((i + 1) * slice_w) - 1, lo + 1)
        s = int(rng.integers(lo, hi))
        s = max(s, prev + min_gap)
        steps.append(s)
        prev = s
    order = list(kinds)
    rng.shuffle(order)
    out = []
    for i, step in enumerate(steps):
        kind = order[i % len(order)]
        node = int(rng.integers(0, n))
        graceful = bool(rng.integers(0, 2))
        out.append(Scenario(kind=kind, step=step, node=node,
                            graceful=graceful))
    return out


def ensure_coverage(scenarios, *, kinds, n: int) -> list:
    """Rewrite a plan so it covers every kind in `kinds` at least once,
    keeping steps/nodes/gracefulness fixed (used by CI smokes that must
    hit >=4 distinct kinds regardless of the seed's shuffle)."""
    want = [k for k in kinds if k not in {s.kind for s in scenarios}]
    out = list(scenarios)
    for i in range(len(out) - 1, -1, -1):
        if not want:
            break
        dupes = [s.kind for s in out].count(out[i].kind)
        if dupes > 1:
            out[i] = replace(out[i], kind=want.pop(), params={})
    return out


# ------------------------------------------------------- corruption helpers
def corrupt_shm_stripe(run: str, node: int, n: int, total_bytes: int,
                       *, seed: int = 0, nbytes: int = 16,
                       step: int = None, region: str = "own") -> dict:
    """Flip `nbytes` bytes inside a live CLEAN shm snapshot buffer of
    `node` — real damage in the real segment, detectable only by the CRC
    probe / in-pass restore CRC.  `region="own"` (default) confines the
    flip to the member's data shard, which the snapshot-time `crc_own`
    digest covers; `region="any"` may hit the parity strip too (live
    parity carries no digest — only a durable-tier scrub would see it).
    Returns {step, offset, nbytes}."""
    from repro_torch.core.smp import ReadOnlyNode
    view = ReadOnlyNode(run, node, n, total_bytes)
    try:
        clean = view.clean_steps()
        if not clean:
            raise RuntimeError(f"node {node} has no CLEAN snapshot buffer "
                               "to corrupt")
        tgt = step if step in clean else max(clean)
        idx = clean[tgt]
        shm = view._bufs[idx]
        rng = np.random.default_rng(seed)
        limit = (view.layout.buf_bytes if region == "any"
                 else (total_bytes if n == 1 else view.layout.own_bytes))
        off = int(rng.integers(0, max(limit - nbytes, 1)))
        buf = np.ndarray((limit,), np.uint8, shm.buf)
        buf[off:off + nbytes] ^= 0xFF
        del buf                       # no exported pointers past close()
        return {"step": int(tgt), "offset": off, "nbytes": int(nbytes)}
    finally:
        view.close()


def corrupt_reft_file(path: str, *, seed: int = 0, nbytes: int = 16) -> dict:
    """Flip `nbytes` bytes in a `.reft` member file's data region (past
    the pickled head, so the family still opens but fails its digest /
    CRC check).  Returns {offset, nbytes}."""
    with open(path, "rb") as f:
        pickle.load(f)                # skip the head
        data_off = f.tell()
    size = os.path.getsize(path)
    if size - data_off < nbytes:
        raise RuntimeError(f"{path}: data region too small to corrupt")
    rng = np.random.default_rng(seed)
    off = data_off + int(rng.integers(0, size - data_off - nbytes + 1))
    with open(path, "r+b") as f:
        f.seek(off)
        chunk = bytearray(f.read(nbytes))
        for i in range(len(chunk)):
            chunk[i] ^= 0xFF
        f.seek(off)
        f.write(bytes(chunk))
    return {"offset": off, "nbytes": int(nbytes)}
