"""The readings a cell's limits are set from, at the cell's own size, on
the card: the program's first three steps (as a run's set-up takes
them), the control (the reference computed with float8 products, put in
the program's place) and the planted faults, each against the float32
reference, seed by seed, in one process, each judged by the cell's
limits as a run judges it (`checks.verdict`).

    python3 perfbench/calibrate.py --workload mamba2-130m.b16.nosave \\
        --seeds 1,2,3 --what program,control,half_batch

One JSON line a seed and reading: {"seed", "what", "numbers", "correct",
"leaves", ...}. The benchmark's own runs never run this. A step that
returns its state unchanged reads 1 in grad_gap and change_gap by
construction (the gradient and the change it leaves are nought) and
needs no run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(HERE.parent / "src"), str(HERE.parent)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program,control,half_batch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--base", default=str(HERE),
                    help="the folder holding workloads/, configs/, traffic/")
    args = ap.parse_args(argv)
    from perfbench import checks, harness, reference, spec
    base = Path(args.base)
    cell = spec.cell(args.workload, base)
    c, tr = spec.config(cell["config"], base), spec.traffic(cell["traffic"],
                                                             base)
    import torch
    from repro_torch.api import CheckpointSession, CheckpointSpec
    what = args.what.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        ref = reference.train(c, tr, seed, args.device)
        t_ref = time.time() - t0
        for w in what:
            if w == "control":
                got = reference.train(c, tr, seed, args.device, low=True)
            else:
                plant = None if w == "program" else w
                state, step_fn, feed = harness.program(c, tr, seed,
                                                       args.device, plant)
                with CheckpointSession(CheckpointSpec(backend="null",
                                                      resume=False),
                                       state) as sess:
                    loop = harness.Loop(step_fn, state, sess, feed,
                                        harness.Tracer("", ""))
                    del state
                    got = harness.first_steps(loop, c, tr, seed,
                                               args.device)
                    del loop
            numbers = checks.training(got, ref)
            correct, _ = checks.verdict(numbers, {
                k: v for k, v in cell["limits"].items() if k in numbers})
            leaves = {k: [checks.leaf_dist(got[n][k], ref[n][k])
                          for n in ("grads", "params")] for k in ref["grads"]}
            print(json.dumps({"seed": seed, "what": w, "numbers": numbers,
                              "correct": correct,
                              "leaves": leaves,
                              "losses": got["losses"],
                              "reference_losses": ref["losses"],
                              "reference_s": round(t_ref, 2)}), flush=True)
            del got
            if args.device == "cuda":
                torch.cuda.empty_cache()
        del ref
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
