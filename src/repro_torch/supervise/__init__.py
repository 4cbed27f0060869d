"""Goodput-driven elastic supervision: fault injection, auto-heal/reshard,
and wall-clock accounting.

`Supervisor` and `trees_equal` load on first use: the snapshot managers
start with `spawn` and re-import the launching module
(`python -m repro_torch.supervise.run`), so importing this package must
stay torch-free.
"""
from repro_torch.supervise.goodput import CATEGORIES, GoodputLedger
from repro_torch.supervise.inject import (
    DEFAULT_PARAMS, FAILURE_KINDS, KINDS, Scenario, corrupt_reft_file,
    corrupt_shm_stripe, ensure_coverage, parse_scenario, plan_scenarios,
)

__all__ = [
    "CATEGORIES", "GoodputLedger", "DEFAULT_PARAMS", "FAILURE_KINDS",
    "KINDS", "Scenario", "corrupt_reft_file", "corrupt_shm_stripe",
    "ensure_coverage", "parse_scenario", "plan_scenarios", "Supervisor",
    "trees_equal",
]


def __getattr__(name):
    if name in ("Supervisor", "trees_equal"):
        from repro_torch.supervise import supervisor
        return getattr(supervisor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
