"""The program's spans (`repro_torch.core.spans`): with no profiler they
are one shared no-op; under a CPU profiler a tiny Mamba2 training step
(width 64, 2 layers, `remat` on) computes bit for bit what it computes
without one, its trace holds every site's span, and the benchmark's site
split (`perfbench/sites.py`), fed the step's top-level aten ops as its
device events, leaves under 5 % of their time in `(none)`."""
import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import spans
from repro_torch.core.treebytes import leaf_arrays
from repro_torch.data.pipeline import make_batch
from repro_torch.train.steps import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import sites  # noqa: E402

STEP_SPANS = {"model.embed", "model.block", "model.rms_norm", "ssm.proj",
              "ssm.conv", "ssm.glue", "ssm.scan", "model.loss",
              "optim.adam", "train.rng_fold", "train.step",
              "train.backward"}


def test_without_a_profiler_a_span_is_the_shared_no_op():
    assert not spans.active()
    got = {id(spans.span(n)) for n in STEP_SPANS}
    assert got == {id(spans.OFF)}
    with spans.span("model.block") as s:
        assert s is None


def test_under_a_profiler_a_span_is_recorded(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as p:
        assert spans.active()
        with spans.span("ssm.conv"):
            torch.ones(4).sum()
    assert not spans.active()
    p.export_chrome_trace(str(tmp_path / "t.json"))
    names = {e.get("name") for e in json.loads(
        (tmp_path / "t.json").read_text())["traceEvents"]}
    assert "repro_torch.ssm.conv" in names


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    """One step without a profiler and the same step under one: (their
    outputs, the trace's events)."""
    cfg = dataclasses.replace(get_config("mamba2-130m").reduced(),
                              d_model=64, ssm_state=16, ssm_head_dim=16,
                              ssd_chunk=16, remat=True)
    state = init_train_state(cfg, seed=0, device="cpu")
    batch = make_batch(cfg, InputShape("t", 64, 2, "train"), seed=1,
                       device="cpu")
    step = make_train_step(cfg)
    plain = step(state, batch)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        traced = step(state, batch)
    path = tmp_path_factory.mktemp("spans") / "step.json"
    p.export_chrome_trace(str(path))
    return plain, traced, json.loads(path.read_text())["traceEvents"]


def test_the_step_is_bitwise_equal_under_the_profiler(step_run):
    (s0, m0), (s1, m1), _ = step_run
    a, b = leaf_arrays(s0), leaf_arrays(s1)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for k in m0:
        assert torch.equal(m0[k], m1[k])


def test_the_steps_trace_holds_every_span(step_run):
    events = step_run[2]
    got = {e["name"][len(spans.PREFIX):] for e in events
           if e.get("cat") == "user_annotation"
           and e.get("name", "").startswith(spans.PREFIX)}
    assert STEP_SPANS <= got, STEP_SPANS - got


def _as_device(events):
    """The trace with each top-level aten op (one no other aten op on its
    thread encloses) also a launch and a device event of its own span."""
    ops = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") == "cpu_op"
                  and e["name"].startswith("aten::")),
                 key=lambda e: (e["ts"], -e.get("dur", 0)))
    out, ends, total = list(events), {}, 0.0
    for k, e in enumerate(ops):
        th = (e.get("pid"), e.get("tid"))
        if e["ts"] < ends.get(th, float("-inf")):
            continue                      # inside another aten op
        end = e["ts"] + e.get("dur", 0)
        ends[th] = end
        total += e.get("dur", 0)
        out.append({**e, "cat": "cuda_runtime", "args": {"correlation": k}})
        out.append({"ph": "X", "cat": "kernel", "name": e["name"], "pid": 0,
                    "tid": 7, "ts": e["ts"], "dur": e.get("dur", 0),
                    "args": {"correlation": k}})
    lo = min(e["ts"] for e in events if e.get("ph") == "X")
    hi = max(e["ts"] + e.get("dur", 0) for e in events if e.get("ph") == "X")
    main = next(e for e in events if e.get("name") ==
                "repro_torch.model.embed")
    for name in ("perfbench.stretch", "perfbench.step"):
        out.append({"ph": "X", "cat": "user_annotation", "name": name,
                    "pid": main["pid"], "tid": main["tid"], "ts": lo,
                    "dur": hi - lo})
    return out, total * 1e-6


def test_the_site_split_of_the_steps_aten_time(step_run):
    events, total = _as_device(step_run[2])
    s = sites.summarize(events)
    assert s["steps"] == 1
    assert sum(s["regions"].values()) == pytest.approx(total)
    none = s["regions"].get(sites.NONE, 0.0)
    assert none < 0.05 * total, (none / total, s["regions"])
    # the backward reached its forward sites through the sequence numbers
    assert s["rules"][2] > 0
    for site in ("model.rms_norm", "ssm.conv", "ssm.glue", "ssm.scan",
                 "model.loss", "optim.adam"):
        assert s["regions"].get(site, 0.0) > 0, site
