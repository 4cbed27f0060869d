"""Sharding-group construction over the production mesh (paper §4.1).

The counterpart of `repro/core/sharding_plan.py`: pure integer math over
`core.raim5`, the same plans for the same arguments. Parameters are
sharded over the "model" axis and replicated (or FSDP-sharded) over
"data" (+"pod"). A *sharding group* is the set of hosts that hold the
same model-axis slice across the data axis: the direct analogue of "one
PP stage across all DP paths". Each SG member snapshots an orthogonal
1/n byte-shard of the slice plus its RAIM5 parity stripe; the pod axis
multiplies the number of SGs, never their size, so single-node
protection holds at any scale.

Hosts are modeled as `chips_per_host` consecutive chips along the model
axis (default 4, the reference's; an 8-GPU H100 host is
`chips_per_host=8`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.core import raim5


@dataclass(frozen=True)
class HostPlan:
    host: Tuple[int, ...]          # (pod, data, model_block) coordinates
    sg_id: Tuple[int, ...]         # (pod, model_block)
    member: int                    # rank within the SG (= data index)
    sg_size: int
    slice_lo: int                  # this SG's byte slice of the full state
    slice_hi: int
    snapshot_ranges: List[Tuple[int, int]]   # absolute byte ranges to save
    snapshot_bytes: int


def build_plan(total_state_bytes: int, *, data: int = 16, model: int = 16,
               pods: int = 1, chips_per_host: int = 4
               ) -> Dict[Tuple[int, ...], HostPlan]:
    """Host -> plan for the whole mesh.

    The state byte-stream is cut into `model_blocks` slices (one per
    model-axis host column); each slice is protected by one SG of `data`
    members per pod.
    """
    assert model % chips_per_host == 0
    model_blocks = model // chips_per_host
    per_slice = -(-total_state_bytes // model_blocks)
    plans = {}
    for pod in range(pods):
        for mb in range(model_blocks):
            lo = min(mb * per_slice, total_state_bytes)
            hi = min(lo + per_slice, total_state_bytes)
            for d in range(data):
                ranges = [(lo + a, lo + b) for a, b in
                          raim5.snapshot_ranges(d, data, hi - lo)]
                plans[(pod, d, mb)] = HostPlan(
                    host=(pod, d, mb),
                    sg_id=(pod, mb),
                    member=d,
                    sg_size=data,
                    slice_lo=lo, slice_hi=hi,
                    snapshot_ranges=ranges,
                    snapshot_bytes=sum(b - a for a, b in ranges),
                )
    return plans


def plan_summary(plans: Dict[Tuple[int, ...], HostPlan]) -> dict:
    sgs = {}
    for p in plans.values():
        sgs.setdefault(p.sg_id, []).append(p)
    per_host = [p.snapshot_bytes for p in plans.values()]
    return {
        "hosts": len(plans),
        "sgs": len(sgs),
        "sg_size": next(iter(plans.values())).sg_size,
        "max_snapshot_bytes_per_host": max(per_host),
        "mean_snapshot_bytes_per_host": sum(per_host) / len(per_host),
    }
