"""A whole run of the harness on the CPU at a tiny size (the look for a
chip skipped): a temporary configuration, traffic, cell and metric, each
a new file that the harness finds by name, and the run with the timed
path broken underneath each way a cell can break, which has to come out
not correct."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import harness, spec  # noqa: E402

# set from this size's readings on the CPU (test_perfbench_reference)
LIMITS = {"grad_norm_gap": 0.04, "change_norm_gap": 0.02}


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A copy of the benchmark's folder with a tiny configuration, three
    traffic mixes, three cells and one more metric added as files."""
    root = tmp_path_factory.mktemp("bench")
    base = root / "perfbench"
    shutil.copytree(ROOT / "perfbench", base,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    c = spec.config("mamba2-130m")
    c.update(name="tiny-ssm", num_layers=2, d_model=64, vocab_size=256,
             ssm_state=16, ssm_head_dim=16, ssd_chunk=16)
    (base / "configs" / "tiny-ssm.json").write_text(json.dumps(c))
    # a failure after each window step, so that even a window of one step
    # under a loaded host holds a restore
    for name, src, failure in (
            ("tiny.nosave", "b16x2048.nosave", None),
            ("tiny.save", "b16x2048.nodeloss", None),
            ("tiny.nodeloss", "b16x2048.nodeloss", [1])):
        t = dict(spec.traffic(src), batch=4, seq=64, warmup_flights=1,
                 reference_rows=2)
        if "failure" in t:
            t["failure"] = dict(t["failure"], every_steps=failure) \
                if failure else None
        (base / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for name, tr, extra in (
            ("tiny.nosave", "tiny.nosave", {}),
            ("tiny.save", "tiny.save", {"snapshot_bytes": 0.0}),
            ("tiny.nodeloss", "tiny.nodeloss",
             {"restore_bytes": 0.0, "resume_loss_gap": 0.0})):
        (base / "workloads" / f"{name}.json").write_text(json.dumps(
            {"config": "tiny-ssm", "traffic": tr, "chips": 1,
             "limits": {**LIMITS, **extra}}))
    (base / "metrics" / "window_steps.py").write_text(
        "def read(rec):\n    return rec['window']['steps']\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.save", "config": "tiny-ssm",
                               "traffic": "tiny.save", "chips": 1,
                               "why": "a test's cell"})
    bench["per_layer"].append({"name": "window_steps", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "model step",
                               "moves": "tokens_per_s",
                               "workloads": ["tiny.save"]})
    bench["end_to_end"][0]["workloads"].append("tiny.save")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


def test_new_files_are_found_by_name(base):
    bench = spec.benchmark(base.parent)
    assert spec.cell("tiny.save", base)["config"] == "tiny-ssm"
    assert spec.config("tiny-ssm", base)["d_model"] == 64
    assert spec.traffic("tiny.nodeloss", base)["failure"]["every_steps"] \
        == [1]
    assert ("window_steps", "steps") in spec.metrics_of(bench, "tiny.save",
                                                        True)
    assert spec.reader("window_steps", base)({"window": {"steps": 3}}) == 3
    with pytest.raises(FileNotFoundError):
        spec.cell("no-such-cell", base)
    with pytest.raises(ValueError):
        spec.config("../configs/tiny-ssm", base)


def _run(base, cell, plant=None):
    return harness.run(cell, 2 ** 31 + 17, 1.0, False, device="cpu",
                       plant=plant, base=base)


def test_a_sound_run_is_correct(base):
    out = _run(base, "tiny.save")
    assert out["correct"], out["checks"]
    assert out["attempted"] == out["record"]["window"]["steps"] > 0
    bench = spec.benchmark(base.parent)
    got = harness.metric_values(bench, "tiny.save", False, out["record"],
                                base)
    assert set(got) == {"tokens_per_s", "setup_s"}
    got = harness.metric_values(bench, "tiny.save", True, out["record"],
                                base)
    assert got["window_steps"]["value"] == out["attempted"]


def test_a_sound_run_with_failures_is_correct(base):
    out = _run(base, "tiny.nodeloss")
    assert out["correct"], out["checks"]
    restores = out["record"]["window"]["restores"]
    assert restores and all(r["bytes"] == 0 for r in restores)
    assert out["checks"]["resume_loss_gap"] == [0.0, 0.0]


def test_failure_counts_are_one_set_in_an_order_from_the_seed():
    def first(seed, n):
        it = harness.failure_counts({"every_steps": [10, 11, 12]}, seed)
        return [next(it) for _ in range(n)]
    assert first(2 ** 31 + 3, 6) == first(2 ** 31 + 3, 6)
    assert sorted(first(5, 3)) == [10, 11, 12] == sorted(first(6, 3))
    assert first(5, 6)[:3] == first(5, 6)[3:]
    assert len({tuple(first(s, 3)) for s in range(20)}) > 1


@pytest.mark.parametrize("cell, plant, number", [
    ("tiny.nosave", "unchanged", "grad_norm_gap"),
    ("tiny.nosave", "half_batch", "grad_norm_gap"),
    ("tiny.nosave", "control", "grad_norm_gap"),
    ("tiny.save", "snapshot_byte", "snapshot_bytes"),
    ("tiny.nodeloss", "restore_byte", "restore_bytes"),
    ("tiny.nodeloss", "resume_skip", "resume_loss_gap"),
])
def test_a_broken_run_is_not_correct(base, cell, plant, number):
    out = _run(base, cell, plant)
    assert not out["correct"]
    value, limit = out["checks"][number]
    assert value > limit
