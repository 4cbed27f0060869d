"""The plain reference against the program at a tiny size on the CPU (the
program's CPU route: its kernels' plain versions), in float32: the
weights' layout, the loss and every gradient, and the first three steps'
readings. The control (float8 products) is held to fail a cell's
limits."""
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import (checks, data, harness, reference, spec,  # noqa: E402
                       weights)
from perfbench.reference.model import nll_sum  # noqa: E402


def _tiny(name, **kw):
    c = spec.config(name)
    c.update(num_layers=2, d_model=64, vocab_size=256, ssm_state=16,
             ssm_head_dim=16, ssd_chunk=16)
    c.update(kw)
    return c


@pytest.mark.parametrize("name", ["mamba2-130m"])
def test_layout_is_the_programs_tree(name):
    """One layer at full width: the benchmark's leaves are the program's
    initialisation's leaves, path, shape and type."""
    from repro_torch.models import model as M
    c = dict(spec.config(name), num_layers=1)
    cfg = harness.program_config(c)
    got = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prog = {k: (tuple(v.shape), v.dtype)
            for k, v in weights.flatten(got).items()}
    mine = {x.path: (x.shape, getattr(torch, x.dtype))
            for x in weights.layout(c)}
    assert prog == mine


def test_weights_repeat_from_the_seed():
    c = _tiny("mamba2-130m")
    a, b = weights.make(c, 2 ** 31 + 5, "cpu"), weights.make(c, 2 ** 31 + 5,
                                                             "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    other = weights.make(c, 7, "cpu")
    assert not torch.equal(a[("embed",)], other[("embed",)])
    assert data.batch_numpy(256, 2, 8, 9, 3)["tokens"].tolist() == \
        data.batch_numpy(256, 2, 8, 9, 3)["tokens"].tolist()


@pytest.mark.parametrize("name, seq", [("mamba2-130m", 48)])
def test_reference_loss_and_gradients_match_the_program(name, seq):
    from repro_torch.models import model as M
    c = _tiny(name, dtype="float32", param_dtype="float32")
    cfg = harness.program_config(c)
    flat = {k: v.float() for k, v in weights.make(_tiny(name), 3,
                                                  "cpu").items()}
    b = data.batch(c["vocab_size"], 2, seq, 3, 0, "cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    loss, _ = M.forward(cfg, weights.nest(leaves), b)
    loss.backward()
    ref = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    ref_loss = nll_sum(c, ref, b["tokens"], b["labels"]) / (2 * seq)
    ref_loss.backward()
    assert float(ref_loss.detach()) == pytest.approx(float(loss.detach()),
                                                     rel=1e-5)
    for k in flat:
        g, r = leaves[k].grad, ref[k].grad
        assert torch.allclose(g, r, rtol=1e-3, atol=1e-5 * r.abs().max()), k


def _limits():
    """Set from this size's readings on the CPU over eight seeds: the
    program's largest grad_norm_gap 0.017 and change_norm_gap 0.013; the
    control's least 0.053 and 0.027; half a batch's 0.050 and 0.035."""
    return {"grad_norm_gap": 0.04, "change_norm_gap": 0.02}


def _first_steps(c, tr, seed, plant=None):
    from repro_torch.api import CheckpointSession, CheckpointSpec
    state, step_fn, feed = harness.program(c, tr, seed, "cpu", plant)
    with CheckpointSession(CheckpointSpec(backend="null", resume=False),
                           state) as sess:
        loop = harness.Loop(step_fn, state, sess, feed,
                            harness.Tracer("", ""))
        return harness.first_steps(loop, c, tr, seed, "cpu")


def _traffic():
    return dict(spec.traffic("b16x2048.nosave"), batch=4, seq=64,
                reference_rows=2)


def test_the_program_passes_and_the_control_and_half_batch_fail():
    """At a tiny size: the program's bf16 steps within the limits, the
    reference with float8 products (the control) and the program fed half
    of each batch outside them."""
    c, tr = _tiny("mamba2-130m"), _traffic()
    ref = reference.train(c, tr, 11, "cpu")
    ok, rows = checks.verdict(checks.training(_first_steps(c, tr, 11), ref),
                              _limits())
    assert ok, rows
    low = reference.train(c, tr, 11, "cpu", low=True)
    ok, rows = checks.verdict(checks.training(low, ref), _limits())
    assert not ok, rows
    half = _first_steps(c, tr, 11, "half_batch")
    ok, rows = checks.verdict(checks.training(half, ref), _limits())
    assert not ok, rows


def test_an_unchanged_state_reads_one():
    c, tr = _tiny("mamba2-130m"), _traffic()
    ref = reference.train(c, tr, 12, "cpu")
    got = checks.training(_first_steps(c, tr, 12, "unchanged"), ref)
    for name in ("grad_gap", "change_gap", "grad_norm_gap",
                 "change_norm_gap"):
        assert got[name] == pytest.approx(1.0), name


def test_the_gaps_are_of_values_not_of_norms():
    """A gradient of the right norm but the wrong values (each leaf's
    elements reversed) is far off by value, where a gap of norms reads
    nought."""
    c, tr = _tiny("mamba2-130m"), _traffic()
    ref = reference.train(c, tr, 14, "cpu")
    prog = {"losses": ref["losses"], "params": ref["params"],
            "change_norms": ref["change_norms"],
            "grads": {k: v.flatten().flip(0).reshape(v.shape)
                      for k, v in ref["grads"].items()}}
    got = checks.training(prog, ref)
    assert got["loss_gap"] == got["change_gap"] == 0.0
    assert got["grad_norm_gap"] == pytest.approx(0.0, abs=1e-12)
    assert got["grad_gap"] > 1.0
    assert got["grad_gap.median"] > 1.0


def test_the_value_gap_grows_with_depth():
    """Why the cells compare norms: the bf16 program's first gradient
    departs from the fp32 reference by value more with every layer at
    initialisation (at this width 0.03 at 2 layers, 0.33 at 8), while
    the gap of norms stays small."""
    tr = _traffic()
    got = {}
    for layers in (2, 8):
        c = _tiny("mamba2-130m", num_layers=layers)
        ref = reference.train(c, tr, 21, "cpu")
        got[layers] = checks.training(_first_steps(c, tr, 21), ref)
    assert got[8]["grad_gap.median"] > 5 * got[2]["grad_gap.median"]
    assert got[8]["grad_norm_gap"] < 0.1


def test_the_cells_limits_name_numbers_a_run_computes():
    training = {"loss_gap", "loss_gap.first", "grad_norm_gap",
                "change_norm_gap", "grad_gap", "change_gap",
                "grad_gap.median", "change_gap.median"}
    for cell in json.loads((ROOT / "BENCHMARK.json").read_text())[
            "workloads"]:
        limits = spec.cell(cell["name"])["limits"]
        tr = spec.traffic(cell["traffic"])
        assert limits.keys() & training
        extra = set(limits) - training
        if tr["backend"] == "reft" and not tr.get("failure"):
            assert extra == {"snapshot_bytes"}
            assert limits["snapshot_bytes"] == 0
        elif tr.get("failure"):
            assert extra == {"restore_bytes", "resume_loss_gap"}
            assert limits["restore_bytes"] == 0
        else:
            assert not extra
