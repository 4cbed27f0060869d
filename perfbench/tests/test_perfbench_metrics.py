"""The metrics' arithmetic on synthetic records: the readers found by
name, `step_mfu`, each roofline on synthetic profiler records, the idle
share and the named gaps of a synthetic Chrome trace, and the goodput and
replay accounting of a scripted failure sequence."""
import json
import statistics
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import formulas, spec, tracing  # noqa: E402
from perfbench.peaks import BF16_FLOPS, HBM_BYTES_PER_S  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _record(cfg, traffic, **trace):
    c = spec.config(cfg)
    tr = spec.traffic(traffic)
    steps = 120
    return {
        "config": c, "traffic": tr, "sg_size": 4, "setup_s": 41.5,
        "window": {"seconds": 60.0, "steps": steps,
                   "tokens_per_step": tr["batch"] * tr["seq"],
                   "steps_kept": steps,
                   "step_seconds": [0.5] * 100 + [0.7] * 20,
                   "after_step_seconds": [0.002, 0.004] * 60,
                   "restores": []},
        "trace": {"stretch_s": 10.0, "busy_s": 7.5, "kernels": {},
                  "launches": {}, **trace} if trace else None,
    }


def test_every_metric_of_the_benchmark_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_metrics_of_each_cell():
    names = {w["name"] for w in BENCH["workloads"]}
    for cell in names:
        e2e = dict(spec.metrics_of(BENCH, cell, False))
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(BENCH, cell, True)
    assert dict(spec.metrics_of(BENCH, "mamba2-130m.b16.nosave", False)) \
        == {"tokens_per_s": "tokens/s", "step_p90_s": "s", "setup_s": "s"}


def test_end_to_end_readers():
    rec = _record("mamba2-130m", "b16x2048.nosave")
    assert spec.reader("tokens_per_s")(rec) == 120 * 32768 / 60.0
    assert spec.reader("setup_s")(rec) == 41.5
    p90 = spec.reader("step_p90_s")(rec)
    assert p90 == statistics.quantiles(rec["window"]["step_seconds"], n=10,
                                       method="inclusive")[-1]
    assert 0.5 <= p90 <= 0.7
    assert spec.reader("after_step_ms")(rec) == pytest.approx(3.0)


def test_step_mfu():
    rec = _record("mamba2-130m", "b16x2048.nosave")
    flops = formulas.model_flops(rec["config"], 16, 2048)
    want = 100 * flops * 120 / 60.0 / BF16_FLOPS
    assert spec.reader("step_mfu")(rec) == pytest.approx(want)
    assert spec.reader("step_mfu.nodeloss")(rec) == pytest.approx(want)
    assert 0 < want < 100


def test_ssd_roofline_on_synthetic_kernels():
    f, b = formulas.ssd_bound_s(16, 2048, 24, 64, 128, 256)
    n_f, n_b = 48, 24                     # remat: two forwards a backward
    least = n_f * f + n_b * b
    kernels = {"chunk_state_kernel": [72, least * 2], "ds_kernel": [24,
               least * 2], "vectorized_elementwise_kernel<4>": [9, 5.0]}
    rec = _record("mamba2-130m", "b16x2048.nosave", kernels=kernels,
                  launches={"ssd_scan": n_f, "ssd_scan_bwd": n_b})
    assert spec.reader("ssd_scan_roofline")(rec) == pytest.approx(25.0)
    rec["trace"]["launches"] = {}
    assert spec.reader("ssd_scan_roofline")(rec) is None


def test_encode_roofline_on_synthetic_kernels():
    rec = _record("mamba2-130m", "b16x2048.nodeloss")
    moved, launches = formulas.encode_flight(
        formulas.state_bytes(rec["config"]), 4, 4 << 20)
    per = moved / launches / HBM_BYTES_PER_S
    rec = _record("mamba2-130m", "b16x2048.nodeloss",
                  kernels={"encode_kernel<true>": [300, 300 * per * 4],
                           "encode_kernel<false>": [100, 100 * per * 4]})
    assert spec.reader("encode_bucket_roofline")(rec) == pytest.approx(25.0)
    nosave = _record("mamba2-130m", "b16x2048.nosave",
                     kernels=rec["trace"]["kernels"])
    assert spec.reader("encode_bucket_roofline")(nosave) is None


def test_idle_share_and_named_gaps_of_a_trace():
    us = 1e6

    def x(cat, name, t0, t1):
        return {"ph": "X", "cat": cat, "name": name, "ts": t0 * us,
                "dur": (t1 - t0) * us}
    events = [
        x("user_annotation", "perfbench.stretch", 0.0, 10.0),
        x("user_annotation", "perfbench.step", 0.0, 6.0),
        x("user_annotation", "perfbench.after_step", 6.0, 7.0),
        x("user_annotation", "perfbench.restore", 7.0, 10.0),
        x("kernel", "void ds_kernel(float const*)", 0.5, 3.0),
        x("kernel", "void ds_kernel(float const*)", 2.0, 5.0),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 6.2, 6.4),
        x("kernel", "void encode_kernel<true>(EncodeArgs)", 8.0, 9.0),
        x("kernel", "outside", 11.0, 12.0),
    ]
    t = tracing.summarize(events)
    assert t["stretch_s"] == pytest.approx(10.0)
    assert t["busy_s"] == pytest.approx(4.5 + 0.2 + 1.0)
    assert t["kernels"]["ds_kernel"] == [2, pytest.approx(5.5)]
    assert "outside" not in t["kernels"]
    assert t["idle_gaps"] == [["restore", pytest.approx(1.6)],
                              ["step", pytest.approx(1.2)],
                              ["restore", pytest.approx(1.0)],
                              ["step", pytest.approx(0.5)]]
    assert t["device_ops"][0] == ["ds_kernel", pytest.approx(5.5)]
    rec = {"trace": t}
    share = spec.reader("device_idle_share")(rec)
    assert share == pytest.approx(100 * (1 - 5.7 / 10))
    assert spec.reader("device_idle_share.nodeloss")(rec) == share


def test_goodput_and_replay_on_scripted_failures():
    """Failures at steps 20 and 40 of a window of 60 steps that restore
    steps 17 and 38: 5 steps rolled back."""
    rec = _record("mamba2-130m", "b16x2048.nodeloss")
    w = rec["window"]
    w["restores"] = [{"seconds": 3.0, "failed_at": 20, "restored": 17},
                     {"seconds": 5.0, "failed_at": 40, "restored": 38},
                     {"seconds": 4.0, "failed_at": 55, "restored": 55}]
    w["steps"] = 60
    w["steps_kept"] = 60 - 5
    assert spec.reader("goodput_tokens_per_s")(rec) == 55 * 32768 / 60.0
    assert spec.reader("replayed_steps.nodeloss")(rec) == pytest.approx(5 / 3)
    assert spec.reader("restore_s.nodeloss")(rec) == 4.0
    w["restores"] = []
    assert spec.reader("restore_s.nodeloss")(rec) is None
