"""The port's supervision (`repro_torch.supervise`) against the JAX
package's, on the same inputs; every comparison is exact:

  * the scenario planner (`plan_scenarios`, `ensure_coverage`,
    `parse_scenario`) gives equal plans for several seeds, and
    `corrupt_reft_file` flips the same bytes;
  * `GoodputLedger` on a fake clock gives equal seconds and fractions;
  * `trees_equal` compares torch and numpy leaves byte for byte (bf16 and
    -0.0 included);
  * `Supervisor`, run in both packages over the cluster's numpy trainer
    with the same seven scenarios (every kind, one of them mid-flight,
    the last a preempt that rebuilds the SG 4 -> 2), gives the same event
    sequence and the same final state bytes, and the session's cadence
    tuner, fed the same measurements, retunes to the same intervals;
  * the port's `Supervisor` over the reduced opt-125m train state (torch
    leaves on the CPU) restores byte-exact, and so does
    `python -m repro_torch.supervise.run --device cpu --reduced` with
    `--elastic-to`; without CUDA and without `--device cpu` it raises.
"""
import dataclasses
import itertools
import os
import pickle

import numpy as np
import pytest
import torch

from repro.api import CheckpointSpec as JaxSpec
from repro.core.cluster import make_state as jax_make_state
from repro.core.cluster import update_state as jax_update_state
from repro.core.policy import FailureObserver as JaxObserver
from repro.supervise import GoodputLedger as JaxLedger
from repro.supervise import Scenario as JaxScenario
from repro.supervise import Supervisor as JaxSupervisor
from repro.supervise import corrupt_reft_file as jax_corrupt_reft
from repro.supervise import ensure_coverage as jax_ensure
from repro.supervise import parse_scenario as jax_parse
from repro.supervise import plan_scenarios as jax_plan
from repro.supervise.run import SMOKE_KINDS
from repro_torch.api import CheckpointSpec
from repro_torch.core.cluster import make_state, state_at, update_state
from repro_torch.core.policy import FailureObserver
from repro_torch.core.treebytes import leaf_arrays
from repro_torch.supervise import (
    KINDS, GoodputLedger, Scenario, Supervisor, corrupt_reft_file,
    ensure_coverage, parse_scenario, plan_scenarios, trees_equal,
)

SG = 4
NBYTES = 1 << 14
SEED = 5
# (kind, step, node, graceful, params): every kind, the corrupt-stripe
# mid-flight (its probe drains first, so its restore is deterministic),
# the laggard's stall shorter than its verification restore, the last a
# preempt that rebuilds the SG with 2 members
SCENARIOS = [("software", 2, 1, True, {}),
             ("node", 4, 2, True, {}),
             ("corrupt-stripe", 6, 1, False, {}),
             ("smp", 8, 3, True, {}),
             ("slow-persist", 10, 2, True, {"delay_s": 0.05}),
             ("laggard", 12, 0, True, {"lag_s": 0.05}),
             ("preempt", 14, 3, True, {"new_sg": 2})]
STEPS = 16
EVENT_KEYS = ("kind", "node", "fired_step", "recovered", "tier",
              "restored_step", "rolled_back", "bit_exact", "evicted",
              "elastic", "perf_only")


def _asdict(plan):
    return [dataclasses.asdict(s) for s in plan]


# ------------------------------------------------------------ planner
@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("count,steps", [(5, 24), (7, 24), (6, 40)])
def test_plan_and_coverage_match_reference(seed, count, steps):
    for kinds in (KINDS, SMOKE_KINDS, ("node", "smp")):
        want = jax_plan(seed, n=SG, total_steps=steps, count=count,
                        kinds=kinds)
        got = plan_scenarios(seed, n=SG, total_steps=steps, count=count,
                             kinds=kinds)
        assert _asdict(got) == _asdict(want)
        req = kinds[:min(len(kinds), 4)]
        assert _asdict(ensure_coverage(got, kinds=req, n=SG)) == \
            _asdict(jax_ensure(want, kinds=req, n=SG))


@pytest.mark.parametrize("seed,kinds,elastic,inject", [
    (0, ",".join(KINDS), 2, []),
    (3, "", 0, []),
    (5, "node,smp", 3, []),
    (1, "", 2, ["4:node:1", "9:software"]),
])
def test_run_builds_the_reference_scenarios(seed, kinds, elastic, inject):
    import argparse
    from repro.supervise.run import build_scenarios as jax_build
    from repro_torch.supervise.run import build_scenarios
    args = argparse.Namespace(seed=seed, kinds=kinds, elastic_to=elastic,
                              inject=inject, steps=24, scenarios=7)
    assert _asdict(build_scenarios(args, SG)) == \
        _asdict(jax_build(args, SG))


def test_parse_scenario_matches_reference():
    for text in ("12:smp:2", "5:preempt", "3:corrupt-stripe:1",
                 "0:laggard", "9:slow-persist:3"):
        for node in (0, -1):
            assert dataclasses.asdict(parse_scenario(
                text, default_node=node)) == dataclasses.asdict(
                jax_parse(text, default_node=node))
    for bad in ("5:meteor-strike", "nope:node", "1", "1:node:2:3"):
        with pytest.raises(ValueError) as got:
            parse_scenario(bad)
        with pytest.raises(ValueError) as want:
            jax_parse(bad)
        assert str(got.value) == str(want.value)
    assert Scenario("preempt", 3, params={"grace_s": 1.0}).merged_params() \
        == JaxScenario("preempt", 3, params={"grace_s": 1.0}).merged_params()


@pytest.mark.parametrize("seed", [0, 3])
def test_corrupt_reft_file_flips_the_same_bytes(seed, tmp_path):
    body = pickle.dumps({"head": list(range(40))}) \
        + np.random.default_rng(seed).bytes(4096)
    paths = {}
    for pkg in ("jax", "torch"):
        paths[pkg] = tmp_path / f"{pkg}.reft"
        paths[pkg].write_bytes(body)
    want = jax_corrupt_reft(str(paths["jax"]), seed=seed, nbytes=24)
    got = corrupt_reft_file(str(paths["torch"]), seed=seed, nbytes=24)
    assert got == want
    assert paths["torch"].read_bytes() == paths["jax"].read_bytes() != body


# ------------------------------------------------------------- ledger
def test_goodput_ledger_matches_reference_on_a_fake_clock():
    ledgers = []
    for cls in (JaxLedger, GoodputLedger):
        t = [10.0]
        led = cls(clock=lambda: t[0])
        for dt, cat in ((3.0, "compute"), (0.25, "checkpoint_stall"),
                        (0.5, "detect"), (1.5, "restore"),
                        (0.125, "overhead"), (2.0, "compute")):
            t[0] += dt
            led.mark(cat)
        led.transfer("compute", "lost_steps", 1.0)
        led.record_event(kind="node", step=3)
        t[0] += 0.375
        led.close()
        ledgers.append(led)
    want, got = (led.summary() for led in ledgers)
    assert got == want
    assert got["seconds"]["lost_steps"] == 1.0
    assert ledgers[1].check(tol=1e-12)
    with pytest.raises(ValueError):
        ledgers[1].mark("vibes")


# -------------------------------------------------------- trees_equal
def test_trees_equal_is_byte_exact_on_torch_and_numpy_leaves():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((5, 7)).astype(np.float32)
    e = torch.from_numpy(rng.standard_normal(33).astype(np.float32)) \
        .to(torch.bfloat16)
    a = {"p": {"w": torch.from_numpy(w.copy()), "e": e.clone()},
         "step": np.int64(3), "rng": np.array([0, 9], np.uint32)}
    b = {"p": {"w": w.copy(), "e": e.clone()},
         "step": torch.tensor(3, dtype=torch.int64),
         "rng": torch.tensor([0, 9], dtype=torch.uint32)}
    assert trees_equal(a, b) and trees_equal(b, a)
    # one byte of a bf16 leaf
    c = dict(b, p={"w": w.copy(), "e": e.clone()})
    c["p"]["e"].view(torch.uint8)[5] ^= 1
    assert not trees_equal(a, c)
    # one byte of a numpy leaf
    d = dict(b, p={"w": w.copy(), "e": e.clone()})
    d["p"]["w"].reshape(-1).view(np.uint8)[17] ^= 0x80
    assert not trees_equal(a, d)
    # -0.0 and 0.0 are equal numbers but not equal bytes
    assert not trees_equal({"x": np.zeros(3, np.float32)},
                           {"x": -np.zeros(3, np.float32)})
    # a dtype, a shape or a key that differs
    assert not trees_equal({"x": np.zeros(4, np.float32)},
                           {"x": np.zeros(4, np.int32)})
    assert not trees_equal({"x": np.zeros(4, np.float32)},
                           {"x": np.zeros((2, 2), np.float32)})
    assert not trees_equal({"x": np.zeros(4)}, {"y": np.zeros(4)})


# -------------------------------------------------- supervised runs
class _Tick:
    """A fake clock: every call moves it one second on."""

    def __init__(self):
        self._c = itertools.count()

    def __call__(self):
        return float(next(self._c))


def _supervise(pkg, tmp_path):
    jax_side = pkg == "jax"
    spec_cls = JaxSpec if jax_side else CheckpointSpec
    sc_cls = JaxScenario if jax_side else Scenario
    spec = spec_cls(backend="reft", ckpt_dir=str(tmp_path / pkg),
                    sg_size=SG, snapshot_every_steps=1,
                    checkpoint_every_steps=5, bucket_bytes=1 << 20,
                    resume=False)
    state = (jax_make_state if jax_side else make_state)(
        SEED, nbytes_approx=NBYTES)
    step = jax_update_state if jax_side else update_state
    scen = [sc_cls(kind, step=s, node=n, graceful=g, params=p)
            for kind, s, n, g, p in SCENARIOS]
    obs = (JaxObserver if jax_side else FailureObserver)(clock=_Tick())

    def advance(st, s):
        # the trainer lets the last flight land before it steps, so every
        # step is snapshot (a step of the numpy trainer takes microseconds,
        # and which steps found a free flight slot would follow timing)
        sup.sess.wait()
        return step(st, s)

    sup = (JaxSupervisor if jax_side else Supervisor)(
        spec, state, advance, scenarios=scen, observer=obs)
    return sup, sup.run(STEPS)


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("supervise")
    return {pkg: _supervise(pkg, tmp) for pkg in ("jax", "torch")}


def test_supervisor_events_and_final_state_match_reference(both_runs):
    (jsup, want), (tsup, got) = both_runs["jax"], both_runs["torch"]
    for out in (want, got):
        assert out["unrecovered"] == 0
        assert out["kinds"] == sorted(KINDS)
        assert all(b is True for b in out["bit_exact_checks"])
    seq = [[e.get(k) for k in EVENT_KEYS] for e in got["events"]]
    assert seq == [[e.get(k) for k in EVENT_KEYS] for e in want["events"]]
    heals = [e for e in got["events"] if e.get("restored_step") is not None]
    assert [(e["restored_step"], e["rolled_back"]) for e in heals] == \
        [(e["fired_step"], 0) for e in heals]
    by_kind = {e["kind"]: e for e in got["events"]}
    assert by_kind["corrupt-stripe"]["graceful"] is False
    assert by_kind["corrupt-stripe"]["evicted"] == [1]
    assert by_kind["corrupt-stripe"]["tier"] == "raim5"
    assert by_kind["node"]["tier"] == "raim5"
    assert by_kind["preempt"]["elastic"] == "4->2"
    assert by_kind["preempt"]["tier"] == "checkpoint"
    assert by_kind["laggard"]["bit_exact"] is True
    assert tsup.spec.sg_size == jsup.spec.sg_size == 2
    assert got["injected"] == want["injected"] == len(SCENARIOS)
    assert got["failures"] == want["failures"] == 5
    # the same final bytes, which are the oracle's
    assert trees_equal(got["final_state"], want["final_state"])
    assert trees_equal(got["final_state"],
                       state_at(SEED, STEPS, nbytes_approx=NBYTES))
    g = got["goodput"]
    assert g["accounting_error"] <= 0.05 and g["seconds"]["restore"] > 0


def test_retuned_cadence_matches_reference(both_runs):
    """The tuner of each package's last session (the 2-member SG), fed the
    run's failure record (fake-clock arrivals, equal across packages) and
    the same step, snapshot, persist and restore measurements, settles on
    the same intervals."""
    sups = [both_runs[pkg][0] for pkg in ("jax", "torch")]
    assert sups[0].observer.failures == sups[1].observer.failures
    assert len(sups[1].observer.failures) == 5
    stats = {"engine_snapshots": 10, "engine_seconds": 0.5,
             "persist": 2, "persist_seconds": 3.0}
    restores = {"snapshot": [0.25, 0.5, 0.125], "checkpoint": [2.0]}
    cadences = []
    for sup in sups:
        sess = sup.sess
        sess.spec = dataclasses.replace(sess.spec, auto_tune=True)
        sess._step_times = [0.01] * 4
        sess.checkpointer.stats = lambda: dict(stats)
        sup.observer.restores = {k: list(v) for k, v in restores.items()}
        sess._retune()
        cadences.append((sess.snapshot_every, sess.checkpoint_every))
    assert cadences[1] == cadences[0]
    assert cadences[1][0] >= 1 and cadences[1][1] >= cadences[1][0]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_snapshot_after_restore_differs_from_reference_on_purpose(
        pkg, tmp_path):
    """A named difference, pinned in both packages: after a restore the
    port's session snapshots at the next step whatever the cadence (the
    healed member holds nothing until a snapshot lands on it); the JAX
    package's waits for its cadence clock. Snapshots every 4 steps (the
    first at step 3); a node lost after step 6 restores step 3 (RAIM5) in
    both; the replayed step 4 snapshots in the port only, so a second
    member lost after it decodes step 4 there, while the reference, with
    the healed member empty, has two of four holders of step 3 and no
    durable family."""
    from repro.api import CheckpointSession as JaxSession
    from repro.core.recovery import RecoveryError as JaxRecoveryError
    from repro_torch.api import CheckpointSession
    jax_side = pkg == "jax"
    spec = (JaxSpec if jax_side else CheckpointSpec)(
        backend="reft", ckpt_dir=str(tmp_path), sg_size=SG,
        snapshot_every_steps=4, checkpoint_every_steps=10 ** 6,
        resume=False)
    states = {0: make_state(SEED, nbytes_approx=NBYTES)}
    for t in range(1, 8):
        states[t] = update_state(states[t - 1], t)
    session = JaxSession if jax_side else CheckpointSession
    with session(spec, states[0]) as sess:
        launched = [t for t in range(1, 7)
                    if sess.after_step(states[t], t)["snapshot"]]
        assert launched == [3]
        sess.wait()
        sess.inject("node", node=1)
        res = sess.restore()
        assert (res.tier, res.step) == ("raim5", 3)
        assert trees_equal(res.state, states[3])
        again = sess.after_step(states[4], 4)["snapshot"]
        sess.wait()
        sess.inject("node", node=2)
        if jax_side:
            assert again is False
            with pytest.raises(JaxRecoveryError):
                sess.restore()
        else:
            assert again is True
            res = sess.restore()
            assert (res.tier, res.step) == ("raim5", 4)
            assert trees_equal(res.state, states[4])


@pytest.mark.parametrize("case", ["smp death during a slow persist",
                                  "laggard mid-flight, then a node loss"])
def test_port_supervisor_does_not_wedge(case, tmp_path):
    """A stopped or dead SMP mid-flight: the L1 pump and the L2 stager
    wait with bounds, training goes on, and every failure heals
    byte-exact (the reference's compound no-wedge test is the model)."""
    import time
    if case.startswith("smp"):
        scen = [Scenario("slow-persist", step=3, node=1, graceful=False,
                         params={"delay_s": 0.3, "duration_steps": 8}),
                Scenario("smp", step=5, node=1, graceful=False)]
    else:
        scen = [Scenario("laggard", step=3, node=2, graceful=False,
                         params={"lag_s": 0.4}),
                Scenario("node", step=6, node=1, graceful=False)]
    spec = CheckpointSpec(backend="reft", ckpt_dir=str(tmp_path),
                          sg_size=SG, snapshot_every_steps=1,
                          checkpoint_every_steps=3, bucket_bytes=1 << 20,
                          resume=False)
    sup = Supervisor(spec, make_state(SEED, nbytes_approx=NBYTES),
                     lambda st, s: update_state(st, s), scenarios=scen)
    t0 = time.monotonic()
    out = sup.run(10)
    assert time.monotonic() - t0 < 120               # no wedge
    assert out["unrecovered"] == 0
    assert [e["kind"] for e in out["events"]] == [sc.kind for sc in scen]
    assert all(e["bit_exact"] is True for e in out["events"]
               if "bit_exact" in e)
    assert trees_equal(out["final_state"],
                       state_at(SEED, 10, nbytes_approx=NBYTES))


def test_disk_backend_keeps_the_cadence_after_restore(tmp_path):
    """The snapshot after a restore is REFT's (a healed member holds
    nothing); a disk baseline restores what its file holds and keeps the
    reference's cadence."""
    from repro_torch.api import CheckpointSession
    spec = CheckpointSpec(backend="sync_disk", ckpt_dir=str(tmp_path),
                          snapshot_every_steps=4,
                          checkpoint_every_steps=10 ** 6, resume=False)
    states = {0: make_state(SEED, nbytes_approx=NBYTES)}
    for t in range(1, 6):
        states[t] = update_state(states[t - 1], t)
    with CheckpointSession(spec, states[0]) as sess:
        assert [t for t in range(1, 5)
                if sess.after_step(states[t], t)["snapshot"]] == [3]
        res = sess.restore()
        assert (res.tier, res.step) == ("disk", 3)
        assert trees_equal(res.state, states[3])
        assert sess.after_step(states[4], 4)["snapshot"] is False


def test_port_supervisor_restores_opt_state_byte_exact(tmp_path):
    """Torch leaves: the reduced opt-125m train state on the CPU through a
    node loss and a mid-flight stripe corruption, each restore held
    byte for byte against the oracle ring."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.train.steps import init_train_state, make_train_step
    torch.set_num_threads(1)
    cfg = get_config("opt-125m").reduced()
    state = init_train_state(cfg, 0, device="cpu")
    ds = SyntheticDataset(cfg, InputShape("t", 32, 2, "train"), seed=0,
                          device="cpu")
    step_fn = make_train_step(cfg)
    spec = CheckpointSpec(backend="reft", ckpt_dir=str(tmp_path),
                          sg_size=SG, snapshot_every_steps=1,
                          checkpoint_every_steps=4, resume=False)
    scen = [Scenario("node", step=3, node=1, graceful=True),
            Scenario("corrupt-stripe", step=5, node=2, graceful=False)]
    sup = Supervisor(spec, state, lambda st, s: step_fn(st, next(ds))[0],
                     scenarios=scen)
    out = sup.run(7)
    assert out["unrecovered"] == 0
    assert out["bit_exact_checks"] == [True, True]
    assert [e["tier"] for e in out["events"]] == ["raim5", "raim5"]
    assert all(isinstance(x, torch.Tensor)
               for x in leaf_arrays(out["final_state"]))
    assert int(out["final_state"]["step"]) == 7


def test_supervise_run_cli_cpu_reduced_elastic(tmp_path):
    from repro_torch.supervise import run
    torch.set_num_threads(1)
    out = run.run(["--device", "cpu", "--arch", "opt-125m", "--reduced",
                   "--steps", "14", "--batch", "2", "--seq", "32",
                   "--sg-size", "4", "--snapshot-every", "1",
                   "--ckpt-every", "4", "--scenarios", "4", "--seed", "0",
                   "--elastic-to", "2", "--auto-tune",
                   "--ckpt-dir", str(tmp_path / "ckpt"),
                   "--json", str(tmp_path / "goodput.json")])
    assert out["ok"], out["failed"]
    assert out["unrecovered"] == 0
    assert out["bit_exact_checks"] and \
        all(b is True for b in out["bit_exact_checks"])
    assert any(not s["graceful"] for s in out["config"]["scenarios"])
    elastic = [e for e in out["events"] if e.get("elastic")]
    assert [e["elastic"] for e in elastic] == ["4->2"]
    assert elastic[0]["bit_exact"] is True
    assert out["goodput"]["accounting_error"] <= 0.05
    assert out["cadence"] and out["cadence"][0][1:] == [1, 4]
    assert os.path.getsize(tmp_path / "goodput.json") > 0


def test_supervise_run_without_device_raises_on_a_host_without_cuda(
        monkeypatch):
    from repro_torch.supervise import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run.main(["--arch", "opt-125m", "--reduced", "--steps", "1"])
