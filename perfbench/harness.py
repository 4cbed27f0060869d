"""One run of one cell: set-up, warm-up, the measured window, the checks.

The window drives the program's training step (`repro_torch.train.steps.
make_train_step`) inside a `repro_torch.api.CheckpointSession`, as the
program's trainer does: step, `float(loss)` (which synchronises), then
`after_step`. A cell with failures injects a mid-flight node failure a
number of steps after the last restore completed (the traffic's counts,
in an order drawn from the seed) and restores through the session. Set-up
makes the weights and batches from the seed, builds the session, and runs
the three steps the reference follows, then warm-up steps and whole
snapshot flights (and one failure and restore where the cell has them),
so that nothing is built or first touched inside the window. Every cell
runs an SG of 4 members on the one card, one flight at a time, with the
device encode on.
"""
from __future__ import annotations

import dataclasses
import glob
import math
import os
import random
import shutil
import sys
import tempfile
import time
import uuid

from perfbench import checks, data, reference, spec, weights
from perfbench.tracing import Tracer

MIB = 1 << 20
SG_SIZE = 4
ENGINE = {"device_encode": "on", "max_flights": 1}
PLANTS = ("unchanged", "half_batch", "snapshot_byte", "restore_byte",
          "resume_skip", "control")


def program_config(c: dict):
    """The program's ModelConfig of configuration file `c`: every field
    the file gives, the rest the dataclass's defaults."""
    from repro_torch.configs.base import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(name=c["arch"], **{k: v for k, v in c.items()
                                          if k in fields and k != "name"})


def _flat(tree):
    return weights.flatten(tree)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _flat(tree).values())


def mismatched_bytes(a, b) -> int:
    """Bytes in which two trees of tensors differ (every byte of a leaf
    whose path, type or shape differs)."""
    import torch
    fa, fb = _flat(a), _flat(b)
    n = 0
    for k in set(fa) | set(fb):
        x, y = fa.get(k), fb.get(k)
        if x is None or y is None or x.dtype != y.dtype \
                or x.shape != y.shape:
            n += max(t.numel() * t.element_size() for t in (x, y)
                     if t is not None)
            continue
        xb = x.contiguous().reshape(-1).view(torch.uint8)
        yb = y.to(x.device).contiguous().reshape(-1).view(torch.uint8)
        n += int((xb != yb).sum())
    return n


def _flip_a_byte(tree):
    import torch
    leaf = next(iter(_flat(tree).values()))
    leaf.reshape(-1).view(torch.uint8)[0] ^= 1


def shm_need(state_bytes: int, n: int, stage_slots: int = 8,
             bucket: int = 4 * MIB) -> int:
    """/dev/shm the SMPs take: per member 3 buffers of its own blocks and
    parity (n blocks of ceil(W / (n (n - 1))) bytes, plus a 1 MiB
    metadata slot) and its staging slots."""
    bs = -(-state_bytes // (n * (n - 1)))
    return n * (3 * (n * bs + MIB) + stage_slots * bucket)


class Loop:
    """The trainer's loop, step by step, with the harness's spans."""

    def __init__(self, step_fn, state, sess, feed, tracer, hold=False):
        self.step_fn, self.state, self.sess, self.feed = step_fn, state, \
            sess, feed
        self.tracer = tracer
        self.step = 0
        self.hold = hold
        self.held = {}             # launched step -> the state launched
        self.rounds = []           # steps every member launched
        self.resumed = None        # a restore whose first step is due
        self.step_seconds, self.after_seconds = [], []
        self.launches = []         # a step's flights: S all, P some, - none
        self.losses = []

    def one(self):
        t0 = time.perf_counter()
        with self.tracer.span("feed"):
            batch = self.feed(self.step)
        with self.tracer.span("step"):
            self.state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])
        self.step += 1
        t1 = time.perf_counter()
        with self.tracer.span("after_step"):
            did = self.sess.after_step(self.state, self.step,
                                       extra_meta={"step": self.step})
        t2 = time.perf_counter()
        self.step_seconds.append(t2 - t0)
        self.launches.append("S" if did["snapshot"] else
                             "P" if did["launched"] else "-")
        self.after_seconds.append(t2 - t1)
        self.losses.append(loss)
        if self.resumed is not None:
            self.resumed["loss"] = loss
            self.resumed = None
        self.last = did
        if self.hold and did["launched"]:
            # a restore returns a step some member launched, as a rule no
            # older than the third newest that every member launched: hold
            # those
            self.held[self.step] = self.state
            if did["snapshot"]:
                self.rounds = self.rounds[-2:] + [self.step]
            for k in [k for k in self.held
                      if self.rounds and k < self.rounds[0]]:
                del self.held[k]
        return loss


def program(c: dict, tr: dict, seed: int, device, plant: str = None):
    """-> (the program's initial state from the benchmark's weights, its
    training step (with a planted fault, if asked), the feed of batch
    i)."""
    import torch
    from repro_torch.optim.adam import AdamConfig, adam_init
    from repro_torch.train.steps import make_train_step, prng_key
    params = weights.nest(weights.make(c, seed, device))
    state = {"params": params, "opt_state": adam_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device),
             "rng": torch.from_numpy(prng_key(seed + 1)).to(device)}
    opt = tr["optimizer"]
    train_step = make_train_step(program_config(c), AdamConfig(
        lr=opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
        weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"]))
    step_fn = train_step
    rows = tr["batch"]
    if plant == "unchanged":
        def step_fn(s, b):
            return s, train_step(s, b)[1]
    elif plant == "half_batch":
        # half the rows, or of a single row's tokens
        def step_fn(s, b):
            return train_step(s, {k: v[:rows // 2] if rows > 1 else
                                  v[:, :v.shape[1] // 2]
                                  for k, v in b.items()})

    def feed(i):
        return data.batch(c["vocab_size"], rows, tr["seq"], seed, i, device)
    return state, step_fn, feed


def first_steps(loop: "Loop", c: dict, tr: dict, seed: int,
                device) -> dict:
    """Run the loop's first three steps; -> the program's readings: each
    step's loss, each leaf's first gradient as the optimizer got it (mu
    after step 1 over 1 - b1) and each parameter after the three steps,
    on the host, and the norm of each leaf's change over the three steps
    (against the weights made again from the seed)."""
    import torch
    prog = {"losses": []}
    for i in range(3):
        prog["losses"].append(loop.one())
        if i == 0:
            scale = 1.0 / (1.0 - tr["optimizer"]["b1"])
            prog["grads"] = {"/".join(k): (v * scale).cpu() for k, v in
                             _flat(loop.state["opt_state"]["mu"]).items()}
    w0 = weights.make(c, seed, device)
    params = _flat(loop.state["params"])
    prog["change_norms"] = {"/".join(k): float(torch.linalg.vector_norm(
        (v.float() - w0[k].float()).double())) for k, v in params.items()}
    prog["params"] = {"/".join(k): v.cpu() for k, v in params.items()}
    return prog


def failure_counts(failure: dict, seed: int):
    """The steps from each restore to the next failure: the traffic's
    counts, in an order drawn from the seed, repeated."""
    counts = list(failure["every_steps"])
    random.Random(int(seed)).shuffle(counts)
    while True:
        yield from counts


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", plant: str = None, t_start: float = None,
        base=spec.HERE, log=sys.stderr) -> dict:
    """Run cell `cell_name` and return its result (without the module
    check, which the caller makes in the process that prints). `plant`
    breaks the timed path underneath (`PLANTS`), or with "control" puts
    the reference in lower precision in the program's place."""
    t_start = time.time() if t_start is None else t_start
    if plant is not None and plant not in PLANTS:
        raise ValueError(f"unknown fault {plant!r}")
    cell = spec.cell(cell_name, base)
    c = spec.config(cell["config"], base)
    tr = spec.traffic(cell["traffic"], base)
    import torch
    from repro_torch.api import CheckpointSession, CheckpointSpec
    from repro_torch.kernels import launch_counts
    from repro_torch.train.steps import state_to

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rows, seq = tr["batch"], tr["seq"]

    # ---------------------------------------------------------- set-up
    state, step_fn, feed = program(c, tr, seed, device, plant)

    run_id = "pb" + uuid.uuid4().hex[:10]
    tmp = tempfile.gettempdir()
    reft = tr["backend"] == "reft"
    if reft:
        state_bytes = _nbytes(state)
        need = shm_need(state_bytes, SG_SIZE)
        free = shutil.disk_usage("/dev/shm").free
        print(f"[setup] /dev/shm free {free} B, need {need} B (state "
              f"{state_bytes} B, {SG_SIZE} SMPs x 3 buffers + staging)",
              file=log)
        if free < need:
            raise SystemExit(f"/dev/shm has {free} B free; the cell's SMPs "
                             f"need {need} B")
    sess = CheckpointSession(CheckpointSpec(
        backend=tr["backend"], ckpt_dir=os.path.join(tmp, f"perfbench-"
                                                          f"{run_id}"),
        sg_size=SG_SIZE, snapshot_every_steps=tr.get("snapshot_every", 1),
        checkpoint_every_steps=10 ** 9, run_id=run_id, resume=False,
        options=dict(ENGINE)), state)
    try:
        tracer = Tracer(tmp, run_id)
        failure = tr.get("failure")
        loop = Loop(step_fn, state, sess, feed, tracer, hold=bool(failure))
        del state
        restores = []
        held_at = []               # the state held at each restored step

        def fail_and_restore(record):
            t0 = time.perf_counter()
            with tracer.span("restore"):
                sess.inject(failure["kind"], node=failure["node"],
                            graceful=failure.get("graceful", False))
                res = sess.restore()
                restored = state_to(res.state, device)
                sync()
            dt = time.perf_counter() - t0
            if plant == "restore_byte":
                _flip_a_byte(restored)
            held = loop.held.get(res.step)
            bad = mismatched_bytes(restored, held) if held is not None \
                else _nbytes(restored)
            loop.state, loop.step = restored, res.step
            if plant == "resume_skip":
                loop.step += 1
            loop.held = {k: v for k, v in loop.held.items() if k <= res.step}
            if record:
                restores.append({"seconds": dt, "failed_at": failed_at,
                                 "restored": res.step, "tier": res.tier,
                                 "bytes": bad})
                held_at.append(held)
                loop.resumed = restores[-1]

        # the three steps the reference follows, through the window's own call
        prog = first_steps(loop, c, tr, seed, device)
        # warm-up: whole flights (each of the SMPs' buffers written once),
        # then steps, then a failure and its restore where the cell has them
        for _ in range(tr.get("warmup_flights", 0) if reft else 0):
            sess.drain()
            loop.one()
            while not loop.last["snapshot"]:
                loop.one()
        for _ in range(tr.get("warmup_steps", 2)):
            loop.one()
        if failure:
            failed_at = loop.step
            fail_and_restore(record=False)
            counts = failure_counts(failure, seed)
            due = next(counts)
        since_restore = 0
        del loop.step_seconds[:], loop.after_seconds[:], loop.losses[:]
        del loop.launches[:]

        # ---------------------------------------------------------- window
        # the traced stretch: `steps` steps after `after_steps`, or with no
        # `steps`, through the window's first restore
        stretch = tr.get("trace", {}) if trace else {}
        sync()
        t0 = time.perf_counter()
        setup_s = time.time() - t_start
        steps = 0
        if stretch and stretch["after_steps"] == 0:
            tracer.start(launch_counts)
        while True:
            loop.one()
            steps += 1
            since_restore += 1
            restored_now = False
            if failure and since_restore >= due:
                failed_at = loop.step
                fail_and_restore(record=True)
                since_restore, due, restored_now = 0, next(counts), True
            if stretch and steps == stretch["after_steps"] > 0:
                tracer.start(launch_counts)
            elif tracer.active and (
                    steps == stretch["after_steps"] + stretch["steps"]
                    if stretch.get("steps") else restored_now):
                tracer.stop(launch_counts)
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
        if tracer.active:
            tracer.stop(launch_counts)
        if trace:
            tracer.read()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        rolled = sum(r["failed_at"] - r["restored"] for r in restores)
        record = {
            "cell": cell_name, "config": c, "traffic": tr, "seed": seed,
            "sg_size": SG_SIZE, "setup_s": setup_s,
            "window": {"seconds": window_s, "steps": steps,
                       "tokens_per_step": rows * seq,
                       "steps_kept": steps - rolled,
                       "step_seconds": list(loop.step_seconds),
                       "after_step_seconds": list(loop.after_seconds),
                       "launches": "".join(loop.launches),
                       "restores": restores},
            "trace": tracer.record,
        }

        # ---------------------------------------------------------- checks
        numbers = {}
        if reft and not failure:
            # the window's last state through the same snapshot call, landed
            # on every member, then restored by the session
            loop.held.clear()
            sess.drain()
            sess.snapshot(loop.state, loop.step, {"step": loop.step},
                          wait=True)
            res = sess.restore()
            restored = state_to(res.state, device)
            if plant == "snapshot_byte":
                _flip_a_byte(restored)
            numbers["snapshot_bytes"] = float(
                mismatched_bytes(restored, loop.state)
                if res.step == loop.step else _nbytes(restored))
            print(f"[check] newest snapshot: step {res.step} (taken at "
                  f"{loop.step}), tier {res.tier}", file=log)
            del restored, res
        if failure:
            numbers["restore_bytes"] = float(sum(r["bytes"] for r in restores))
            # each restore's first step again, from the state held before
            # the failure: the training that continues from a restore is
            # the training that would have gone on without it
            if loop.resumed is not None:
                # the window closed on a restore: its first step, now
                _, m = step_fn(loop.state, feed(loop.step))
                loop.resumed["loss"] = float(m["loss"])
            gaps = []
            loop.held.clear()
            loop.state = None
            for r, held in zip(restores, held_at):
                if held is None or "loss" not in r:
                    gaps.append(math.inf)
                    continue
                _, m = step_fn(held, feed(r["restored"]))
                gaps.append(abs(r.pop("loss") - float(m["loss"])))
            numbers["resume_loss_gap"] = max(gaps, default=math.inf)
            del held_at[:]
    finally:
        sess.close(final_persist=False)
    left = glob.glob(f"/dev/shm/reft-{run_id}-*")
    if left:
        raise RuntimeError(f"the run left {len(left)} SMP segments behind: "
                           f"{left[:3]}")
    shutil.rmtree(os.path.join(tmp, f"perfbench-{run_id}"),
                  ignore_errors=True)
    window_losses = list(loop.losses)
    del loop, sess
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference.train(c, tr, seed, device)
    if plant == "control":
        prog = reference.train(c, tr, seed, device, low=True)
    print(f"[check] reference: {time.perf_counter() - t_ref:.1f} s",
          file=log)
    numbers = {**checks.training(prog, ref), **numbers}
    correct, rows_ = checks.verdict(numbers, cell["limits"])
    return {
        "correct": correct,
        "attempted": steps,
        "failed": sum(1 for x in window_losses if not math.isfinite(x)),
        "record": record,
        "checks": rows_,
        "numbers": numbers,
        "memory_peak_bytes": peak,
        "losses": {"program": prog["losses"], "reference": ref["losses"]},
    }


def metric_values(bench: dict, cell_name: str, trace: bool, record: dict,
                  base=spec.HERE) -> dict:
    out = {}
    for name, unit in spec.metrics_of(bench, cell_name, trace):
        value = spec.reader(name, base)(record)
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    return out
