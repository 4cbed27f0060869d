"""The site split of a traced stretch (`perfbench/sites.py`) on synthetic
Chrome traces: each rule that gives a device event its site, the idle
gaps' names, the five figures in ms a step, and the tracer that adds the
split to the stretch's record without changing what `tracing.summarize`
gives."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import sites, tracing  # noqa: E402

T, A, P = (1, 100), (1, 200), (1, 300)   # trainer, autograd, pump threads


def x(cat, name, t0, t1, th=T, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": th[0], "tid": th[1],
            "ts": float(t0), "dur": float(t1 - t0), "args": args}


def span(name, t0, t1, th=T):
    return x("user_annotation", name, t0, t1, th)


def op(name, t0, t1, th, seq, fwd=0):
    return x("cpu_op", name, t0, t1, th, **{"Sequence number": seq,
                                            "Fwd thread id": fwd})


def launch(corr, t, th):
    return x("cuda_runtime", "cudaLaunchKernel", t, t + 1, th,
             correlation=corr)


def kernel(corr, t0, t1, name="void elementwise_kernel<4>(float*)"):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
            "ts": float(t0), "dur": float(t1 - t0),
            "args": {"correlation": corr}}


def trace():
    """One step (microseconds): a forward conv kernel and a block kernel
    on the trainer's thread; a layer recomputed on autograd's thread
    whose forward op reuses the conv op's sequence number (another
    thread's counter); the conv's backward there; a kernel outside every
    span; the pump inside a read at one gap's midpoint."""
    ev = [
        span("perfbench.stretch", 0, 1000),
        span("perfbench.step", 0, 900),
        span("perfbench.after_step", 900, 1000),
        span("repro_torch.model.block", 10, 100),
        span("repro_torch.ssm.conv", 20, 40),
        span("repro_torch.train.rng_fold", 600, 700),
        op("aten::mul", 25, 30, T, seq=5),
        op("aten::add", 60, 62, T, seq=6),
        launch(1, 26, T), kernel(1, 50, 70),
        launch(2, 45, T), kernel(2, 70, 80),
        # the recompute, on autograd's thread: its own span and counter
        span("repro_torch.ssm.glue", 190, 210, A),
        op("aten::mul", 200, 205, A, seq=5),
        launch(3, 195, A), kernel(3, 210, 230, "direct_copy_kernel"),
        # the backward of the forward ops 5 and 6 (forward thread id 1)
        op("autograd::engine::evaluate_function: MulBackward0", 300, 340,
           A, seq=5, fwd=1),
        op("MulBackward0", 301, 339, A, seq=5, fwd=1),
        launch(4, 310, A), kernel(4, 400, 450),
        op("autograd::engine::evaluate_function: AddBackward0", 341, 350,
           A, seq=6, fwd=1),
        # no span, no op: (none)
        launch(5, 860, T), kernel(5, 870, 880),
        # the pump reads at the gap (230, 400): listed, never its name
        span("repro_torch.reft.l1.read", 300, 330, P),
    ]
    return ev


def test_each_device_event_gets_its_site():
    s = sites.summarize(trace())
    us = 1e-6
    assert s["regions"] == {
        "ssm.conv": pytest.approx((20 + 50) * us),   # forward + backward
        "model.block": pytest.approx(10 * us),
        "ssm.glue": pytest.approx(20 * us),          # the recompute
        sites.NONE: pytest.approx(10 * us)}
    assert s["rules"] == {1: 3, 2: 1, 3: 1}
    assert s["region_kernels"]["ssm.glue"] == {
        "direct_copy_kernel": pytest.approx(20 * us)}


def test_a_backward_maps_through_its_forward_threads_sequence():
    """The backward's forward thread id stands for the trainer's thread
    (both its numbers are there); the recompute's op 5 on autograd's
    thread, though later, is not its forward."""
    t = sites.Trace(trace())
    fwd, owner = t._forward_sites()
    assert owner == {1: T}
    assert t.launch_sites()[4] == ("ssm.conv", 2)


def test_a_backward_inside_a_span_of_its_own_thread():
    """On one thread (autograd on the CPU runs on the caller's) a backward
    function inside `train.backward` still maps through its number, a
    recompute span inside the backward function is its own site, and a
    launch in `train.backward` outside both is that span's."""
    ev = trace() + [
        span("repro_torch.train.backward", 500, 560),
        op("autograd::engine::evaluate_function: AddBackward0", 510, 530,
           T, seq=6, fwd=1),
        launch(6, 515, T), kernel(6, 560, 565),
        span("repro_torch.ssm.glue", 516, 520),
        launch(7, 517, T), kernel(7, 565, 566),
        launch(8, 540, T), kernel(8, 566, 567)]
    got = sites.Trace(ev).launch_sites()
    assert got[6] == ("model.block", 2)
    assert got[7] == ("ssm.glue", 1)
    assert got[8] == ("train.backward", 1)


def test_the_external_id_names_the_launching_thread():
    """A launch whose own thread id is an exited thread's (S) carries the
    External id of the op it was made in, on the pump's thread P."""
    S = (1, 400)
    ev = trace() + [
        x("cpu_op", "aten::_to_copy", 305, 309, P, **{"External id": 77}),
        x("cuda_runtime", "cudaMemcpyAsync", 306, 307, S, correlation=9,
          **{"External id": 77}),
        {**kernel(9, 450, 460), "cat": "gpu_memcpy"}]
    assert sites.Trace(ev).launch_sites()[9] == ("reft.l1.read", 1)
    ev[-2]["args"]["External id"] = 78          # no such op: its own id
    assert sites.Trace(ev).launch_sites()[9] == (sites.NONE, 3)


def test_gaps_are_named_by_the_trainers_spans_only():
    """The pump's read covers the midpoint of the gap from 230 to 400: it
    is listed beside the gap and does not name it."""
    s = sites.summarize(trace())
    assert [[n, round(d * 1e6)] for n, d in s["idle_gaps"]] == [
        ["step/train.rng_fold", 420], ["step", 170], ["step", 130],
        ["after_step", 120], ["step/ssm.conv", 50]]
    assert s["gap_threads"] == [[], ["reft.l1.read"], [], [], []]


def test_the_five_figures_are_ms_a_step():
    ev = trace()
    s = sites.summarize(ev)
    assert s["steps"] == 1
    f = sites.figures(s)
    assert set(f) == {"rms_norm_ms", "ssm_conv_ms", "ssd_glue_ms",
                      "loss_ms", "adam_ms"}
    assert f["ssm_conv_ms"] == pytest.approx(0.070)
    assert f["ssd_glue_ms"] == pytest.approx(0.020)
    assert f["rms_norm_ms"] == f["loss_ms"] == f["adam_ms"] == 0.0
    # two steps: half as much a step
    ev.append(span("perfbench.step", 950, 990))
    assert sites.figures(sites.summarize(ev))["ssm_conv_ms"] == \
        pytest.approx(0.035)


def test_on_one_stream_the_regions_sum_to_busy():
    s = sites.summarize(trace())
    t = tracing.summarize(trace())
    assert sum(s["regions"].values()) == pytest.approx(t["busy_s"])


def test_the_existing_fixture_reads_as_tracing_reads_it():
    """The metrics test's trace (no program spans, no launches): the
    gaps' names and lengths are tracing's, every device second is
    `(none)`."""
    us = 1e6

    def ev(cat, name, t0, t1):
        return {"ph": "X", "cat": cat, "name": name, "ts": t0 * us,
                "dur": (t1 - t0) * us}
    events = [
        ev("user_annotation", "perfbench.stretch", 0.0, 10.0),
        ev("user_annotation", "perfbench.step", 0.0, 6.0),
        ev("user_annotation", "perfbench.after_step", 6.0, 7.0),
        ev("user_annotation", "perfbench.restore", 7.0, 10.0),
        ev("kernel", "void ds_kernel(float const*)", 0.5, 3.0),
        ev("kernel", "void ds_kernel(float const*)", 2.0, 5.0),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 6.2, 6.4),
        ev("kernel", "void encode_kernel<true>(EncodeArgs)", 8.0, 9.0),
        ev("kernel", "outside", 11.0, 12.0),
    ]
    t = tracing.summarize(events)
    s = sites.summarize(events)
    assert s["idle_gaps"] == t["idle_gaps"]
    assert s["gap_threads"] == [[]] * 4
    assert s["regions"] == {sites.NONE: pytest.approx(2.5 + 3.0 + 0.2 + 1)}


def test_the_tracer_adds_the_split_and_keeps_tracings_record(tmp_path,
                                                            capsys):
    events = trace()

    class Done:
        def export_chrome_trace(self, path):
            Path(path).write_text(json.dumps({"traceEvents": events}))

    tr = sites.tracer_class()(str(tmp_path), "t")
    tr.done, tr.launches = Done(), {"ssd_scan": 2}
    tr.read()
    base = tracing.summarize(events)
    for k in ("stretch_s", "busy_s", "kernels", "device_ops"):
        assert tr.record[k] == base[k]
    assert tr.record["launches"] == {"ssd_scan": 2}
    assert [g[0] for g in tr.record["idle_gaps"]][:1] == \
        ["step/train.rng_fold"]
    assert tr.record["regions"]["ssm.conv"] == pytest.approx(70e-6)
    err = capsys.readouterr().err
    for line in ("[regions]", "[sites] rms_norm_ms=", "[gaps]",
                 "[site-kernels] ssm.conv:"):
        assert line in err
    assert not list(tmp_path.iterdir())      # the export is removed


def test_innermost_on_nested_and_sibling_spans():
    ivs = [(0, 100, "a"), (10, 20, "b"), (12, 15, "c"), (30, 40, "d")]
    pts = [(5, 1), (13, 2), (18, 3), (35, 4), (50, 5), (150, 6)]
    got = sites.innermost(ivs, pts)
    assert {k: v and v[2] for k, v in got.items()} == {
        1: "a", 2: "c", 3: "b", 4: "d", 5: "a", 6: None}
