"""Reliability model and optimal-frequency policy (paper §5 + Appendix A).

Implements:
  Eq. 1   Weibull single-node survival        P = exp(-lam * t^c)
  Eq. 2   REFT survival (<=1 node loss / SG)  P_re_survive
  Eq. 3   checkpoint-only survival            P_ck_survive
  Eq. 5   classic optimal interval            T = sqrt(2 O_save / lam)
  Eq. 7   REFT unrecoverable-failure rate     lam_re_fail
  Eq. 8   effective saving overhead           O_save = relu(T_ft - T_comp)
  Eq. 9-11 optimal snapshot/checkpoint intervals
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field


def weibull_survival(lam: float, t: float, c: float = 1.0) -> float:
    """Eq. 1: cumulative survival probability of one node at time t."""
    return math.exp(-lam * (t ** c))


def reft_survival(k: int, n: int, t: float, *, lam_hw: float,
                  lam_smp: float = 0.0, c: float = 1.0) -> float:
    """Eq. 2: parameters survive iff every SG of n nodes has <=1 hardware
    failure and all SMPs are healthy. k = total nodes, k/n SGs."""
    assert k % n == 0, "k must be a multiple of the SG size"
    ps = weibull_survival(lam_hw, t, c)
    p_sg = ps ** n + n * (1.0 - ps) * ps ** (n - 1)
    p_smp = weibull_survival(lam_smp, t, c) ** k
    return (p_sg ** (k // n)) * p_smp


def ckpt_survival(k: int, t: float, *, lam_hw: float, lam_sw: float,
                  c: float = 1.0) -> float:
    """Eq. 3: without REFT, in-memory parameters survive only if every node
    survives both hardware and software failures."""
    ps = weibull_survival(lam_hw, t, c)
    ptr = weibull_survival(lam_sw, t, c)
    return (ps ** k) * (ptr ** k)


def safe_horizon(survive_fn, threshold: float = 0.9,
                 t_max: float = 1e5) -> float:
    """Largest t (bisection) with survive_fn(t) >= threshold (Fig. 8's
    '16.22 days vs 0.5 days' numbers)."""
    lo, hi = 0.0, t_max
    if survive_fn(hi) >= threshold:
        return hi
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if survive_fn(mid) >= threshold:
            lo = mid
        else:
            hi = mid
    return lo


def reft_fail_rate(lam_node: float, n: int) -> float:
    """Eq. 7: rate of >=2 failures within an SG of n nodes (the only event
    that forces a restart from a persisted checkpoint)."""
    p = lam_node
    return 1.0 - (1.0 - p) ** n - n * p * (1.0 - p) ** (n - 1)


def effective_save_overhead(t_ft: float, t_comp: float) -> float:
    """Eq. 8: only the part of the fault-tolerance time not hidden behind
    compute counts: O = 0.5 (|T_ft - T_comp| + T_ft - T_comp) = relu(.)"""
    return 0.5 * (abs(t_ft - t_comp) + t_ft - t_comp)


def optimal_interval(o_save: float, lam_fail: float) -> float:
    """Eq. 5: T = sqrt(2 O_save / lambda). O_save==0 -> snapshot every step
    (interval 0 means 'as often as possible')."""
    if lam_fail <= 0:
        return math.inf
    return math.sqrt(2.0 * max(o_save, 0.0) / lam_fail)


@dataclass(frozen=True)
class FrequencyPlan:
    snapshot_interval: float      # seconds between REFT-Sn snapshots
    checkpoint_interval: float    # seconds between REFT-Ckpt persists
    o_snapshot: float
    o_checkpoint: float
    lam_node: float
    lam_unrecoverable: float


def failure_load_rate(lam: float, t_restore: float) -> float:
    """Failure rate per *useful* second.  Each failure burns ~t_restore
    seconds of wall clock that produce no progress, so per useful second
    failures arrive faster than per wall second: lam / (1 - lam*t_restore).
    Clamped so a pathological restore cost cannot send the rate negative
    or unbounded."""
    if lam <= 0:
        return lam
    return lam / max(1.0 - lam * t_restore, 0.05)


def plan_frequencies(*, t_snapshot: float, t_checkpoint: float,
                     t_comp: float, lam_node: float, n: int,
                     t_restore_snapshot: float = 0.0,
                     t_restore_checkpoint: float = 0.0) -> FrequencyPlan:
    """Appendix A, Eqs. 9-11: snapshot interval against single-node failures
    (REFT-Sn repairs those); checkpoint interval against the rare >=2-per-SG
    event (Eq. 7).

    `t_restore_*` fold observed per-tier restore costs (LoadStats read +
    decode + h2d seconds) into the plan: restore time is pure badput, so the
    effective failure rate per useful second rises with it and the optimal
    interval shrinks accordingly."""
    o_sn = effective_save_overhead(t_snapshot, t_comp)
    o_ck = effective_save_overhead(t_checkpoint, t_comp)
    lam_sn = failure_load_rate(lam_node, t_restore_snapshot)
    lam_un = failure_load_rate(reft_fail_rate(lam_node, n),
                               t_restore_checkpoint)
    return FrequencyPlan(
        snapshot_interval=optimal_interval(o_sn, lam_sn),
        checkpoint_interval=optimal_interval(o_ck, lam_un),
        o_snapshot=o_sn,
        o_checkpoint=o_ck,
        lam_node=lam_sn,
        lam_unrecoverable=lam_un,
    )


# Tiers whose restore reads live shm (cheap, snapshot-class) vs tiers that
# hit durable media (expensive, checkpoint-class).  Used to bucket observed
# LoadStats when feeding restore costs back into plan_frequencies.
SNAPSHOT_TIERS = frozenset({"in-memory", "raim5"})


@dataclass
class FailureObserver:
    """Online MTBF + restore-cost estimator feeding plan_frequencies.

    Failure arrivals are modelled as Poisson with a Gamma(w, w/prior)
    conjugate prior, so the posterior rate after observing k failures over
    T node-seconds is (k + w) / (T*n + w/prior): with no evidence it
    returns the static prior (spec.lam_node), and each observed failure
    pulls it toward the measured rate.  `weight` is the prior's
    pseudo-failure count — higher means slower to move off the prior.

    Restore costs are bucketed by recovery tier into snapshot-class
    (in-memory / raim5: shm reads) and checkpoint-class (disk / object
    store) and averaged over the most recent `window` observations.
    """
    weight: float = 2.0
    window: int = 16
    clock: object = time.monotonic       # injectable for tests
    failures: list = field(default_factory=list)     # timestamps
    restores: dict = field(default_factory=lambda: {"snapshot": [],
                                                    "checkpoint": []})
    # learned per-source effective bandwidth (bytes/s) keyed "kind:node",
    # harvested from each restore's LoadStats; seeds the next restore's
    # read-scheduler EWMA priors so a known-slow source starts slow
    source_bw: dict = field(default_factory=dict)
    _t0: float = None

    def __post_init__(self):
        if self._t0 is None:
            self._t0 = self.clock()

    def record_failure(self, when: float = None) -> None:
        self.failures.append(self.clock() if when is None else when)

    def record_restore(self, seconds: float, tier: str = "in-memory",
                       load=None) -> None:
        """Log one restore's cost.  `load` (a LoadStats) refines the
        wall-clock `seconds` with per-phase read/decode/h2d attribution
        when available.  Read and decode are span-based and may overlap
        (pipelined decode), so the phased total subtracts the measured
        intersection instead of double-counting it."""
        if load is not None:
            phased = (getattr(load, "read_seconds", 0.0)
                      + getattr(load, "decode_seconds", 0.0)
                      - getattr(load, "overlap_seconds", 0.0)
                      + getattr(load, "h2d_seconds", 0.0))
            seconds = max(seconds, phased)
            for key, bw in (getattr(load, "source_bandwidth", None)
                            or {}).items():
                self.record_source_bw(key, bw)
        cls = "snapshot" if tier in SNAPSHOT_TIERS else "checkpoint"
        bucket = self.restores[cls]
        bucket.append(float(seconds))
        del bucket[:-self.window]

    def record_source_bw(self, key: str, bw: float) -> None:
        """Blend one observed effective bandwidth (bytes/s) for a restore
        source into the cross-restore estimate (equal-weight EWMA)."""
        if bw is None or bw <= 0:
            return
        prev = self.source_bw.get(key)
        self.source_bw[key] = bw if prev is None else 0.5 * prev + 0.5 * bw

    def observed_span(self) -> float:
        return max(self.clock() - self._t0, 1e-9)

    def lam_node(self, prior: float, n: int = 1) -> float:
        """Posterior per-node failure rate (per second)."""
        prior = max(prior, 1e-12)
        k = len(self.failures)
        t_node = self.observed_span() * max(n, 1)
        return (k + self.weight) / (t_node + self.weight / prior)

    def restore_cost(self, cls: str) -> float:
        bucket = self.restores.get(cls, ())
        return sum(bucket) / len(bucket) if bucket else 0.0

    def mtbf(self) -> float:
        """Observed mean time between failures (inf when none seen)."""
        if not self.failures:
            return math.inf
        return self.observed_span() / len(self.failures)


def total_overhead(t_total: float, t_save_interval: float, o_save: float,
                   lam_fail: float, t_sch: float = 0.0,
                   t_load: float = 0.0) -> float:
    """Eq. 4: O_total = O_save * T/T_save + O_restart * T * lambda, where
    O_restart = T_save/2 (average lost recomputation) + T_sch + T_load."""
    if t_save_interval <= 0:
        return math.inf
    o_restart = t_save_interval / 2.0 + t_sch + t_load
    return (o_save * t_total / t_save_interval
            + o_restart * t_total * lam_fail)
