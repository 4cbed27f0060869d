"""Fault injection for training runs (the parts of the reference's
`supervise/inject.py` that the trainer, the session and the reft backend
use; the supervisor's scenario planner is not ported yet).

The paper treats failures as routine; this module makes them *injectable*
on demand and mid-flight.  A `Scenario` names one fault from the ROADMAP
taxonomy:

  software        trainer-process crash (engine marked UNHEALTHY)
  node            whole-node loss (SMP killed + shm segments unlinked)
  smp             dead Snapshot Management Process only (segments survive)
  laggard         member stalls (SIGSTOP, auto-SIGCONT after lag_s)
  corrupt-stripe  bytes flipped inside a live shm snapshot buffer
  slow-persist    latency injected on the durable-tier write path
  preempt         spot reclaim: SIGTERM-style notice, grace_s to drain,
                  then the node is gone

`corrupt_shm_stripe` writes real damage — XORing bytes in an attached shm
segment — so detection has to be earned by the CRC machinery, not
simulated.
"""
from __future__ import annotations

from dataclasses import dataclass, field

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
