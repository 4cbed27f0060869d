"""The port's sharding-group plan (`repro_torch.core.sharding_plan`)
against the reference's: every host's plan field for field, and the
summary, over the reference test's parameter grid; and the reference's
invariants on the port."""
import dataclasses

import pytest
from hypothesis import given, strategies as st

from repro.core import sharding_plan as ref
from repro_torch.core import raim5
from repro_torch.core.sharding_plan import build_plan, plan_summary


def _same(total, **kw):
    got, want = build_plan(total, **kw), ref.build_plan(total, **kw)
    assert list(got) == list(want)
    for host, p in got.items():
        assert dataclasses.asdict(p) == dataclasses.asdict(want[host]), host
    assert plan_summary(got) == ref.plan_summary(want)
    return got


@pytest.mark.parametrize("total", [1, 10 ** 6, 10 ** 9, 1_904_832_016])
@pytest.mark.parametrize("pods", [1, 2])
def test_production_mesh_plan_equals_the_reference(total, pods):
    _same(total, data=16, model=16, pods=pods, chips_per_host=4)


@given(total=st.integers(1, 10 ** 7),
       data=st.sampled_from([2, 4, 8, 16]),
       model=st.sampled_from([4, 8, 16]),
       pods=st.sampled_from([1, 2]),
       chips_per_host=st.sampled_from([1, 2, 4]))
def test_plans_equal_the_reference(total, data, model, pods, chips_per_host):
    _same(total, data=data, model=model, pods=pods,
          chips_per_host=chips_per_host)


def test_production_mesh_plan_shape():
    plans = build_plan(10 ** 9, data=16, model=16, pods=1, chips_per_host=4)
    s = plan_summary(plans)
    assert s["hosts"] == 64 and s["sgs"] == 4 and s["sg_size"] == 16
    # each host saves ~2 * slice/n bytes (own shard + parity stripe)
    slice_bytes = 10 ** 9 / 4
    assert s["max_snapshot_bytes_per_host"] < 2.2 * slice_bytes / 16


def test_multi_pod_multiplies_sgs_not_size():
    p1 = plan_summary(build_plan(10 ** 8, pods=1))
    p2 = plan_summary(build_plan(10 ** 8, pods=2))
    assert p2["sgs"] == 2 * p1["sgs"]
    assert p2["sg_size"] == p1["sg_size"]


@given(total=st.integers(1, 10 ** 6),
       data=st.sampled_from([2, 4, 8, 16]),
       model=st.sampled_from([4, 8, 16]))
def test_every_byte_protected(total, data, model):
    """Union of all members' OWN data blocks covers each SG slice exactly;
    ranges never cross slice boundaries."""
    plans = build_plan(total, data=data, model=model, pods=1,
                       chips_per_host=4)
    slices = {}
    for p in plans.values():
        if p.slice_hi > p.slice_lo:
            slices.setdefault(p.sg_id, (p.slice_lo, p.slice_hi))
        for a, b in p.snapshot_ranges:
            assert p.slice_lo <= a <= b <= p.slice_hi
    for sg, (lo, hi) in slices.items():
        members = sorted((p for p in plans.values() if p.sg_id == sg),
                         key=lambda p: p.member)
        covered = set()
        for p in members:
            own = p.snapshot_ranges[:p.sg_size - 1] if p.sg_size > 1 \
                else p.snapshot_ranges
            for a, b in own:
                covered.update(range(a - lo, b - lo))
        assert covered == set(range(hi - lo))
        assert sum(p.snapshot_bytes for p in members) == sum(
            b - a for m in range(len(members))
            for a, b in raim5.snapshot_ranges(m, len(members), hi - lo))
