"""Supervised training run: real model, injected failures, goodput report.

The supervisor-shaped sibling of `repro_torch.launch.train`: same
model/data/step wiring, but the loop belongs to `Supervisor` — it fires a
seeded scenario schedule (or explicit `--inject` specs), detects and
heals every fault (elastically resharding on `--elastic-to`), checks each
restore byte-exact against the oracle ring, and emits the
`BENCH_goodput.json` trajectory the CI goodput smoke gates on.

  python -m repro_torch.supervise.run --arch opt-125m --sg-size 4 \\
      --snapshot-every 2 --ckpt-every 8 --steps 24 --seed 0 --auto-tune \\
      --scenarios 7 --elastic-to 2 \\
      --kinds software,node,smp,laggard,corrupt-stripe,slow-persist,preempt
  PYTHONPATH=src python -m repro_torch.supervise.run --device cpu \\
      --arch opt-125m --reduced --steps 24 --batch 2 --seq 64 \\
      --sg-size 4 --snapshot-every 2 --ckpt-every 6 --scenarios 5 \\
      --seed 0 --elastic-to 2 --json BENCH_goodput.json

Runs on CUDA unless `--device cpu` asks for the CPU; with no CUDA device
and no `--device cpu` it raises.  Each step ends with the device drained
(`torch.cuda.synchronize()`), so its queued work lands in the ledger's
`compute` and not in `checkpoint_stall`.  Exits non-zero on any
unrecovered failure, any non-byte-exact restore, a goodput fraction
under `--min-goodput`, or ledger accounting that does not sum to wall
clock within 5%.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

# torch is imported inside `run`: the SMP processes start with `spawn`,
# which re-imports this module, and must stay numpy-only

from repro_torch.supervise.inject import (
    KINDS, Scenario, ensure_coverage, parse_scenario, plan_scenarios,
)

#: kinds a default CI smoke must cover (>=4 distinct, incl. a preempt)
SMOKE_KINDS = ("smp", "corrupt-stripe", "node", "preempt", "slow-persist")


def build_scenarios(args, sg: int) -> list:
    if args.inject:
        out = [parse_scenario(item) for item in args.inject]
    else:
        kinds = tuple(args.kinds.split(",")) if args.kinds else SMOKE_KINDS
        for k in kinds:
            if k not in KINDS:
                raise SystemExit(f"unknown kind {k!r}; want one of {KINDS}")
        out = plan_scenarios(args.seed, n=sg, total_steps=args.steps,
                             count=args.scenarios, kinds=kinds)
        out = ensure_coverage(out, kinds=kinds[:min(len(kinds), 4)], n=sg)
    if out and all(s.graceful for s in out):
        # the acceptance bar wants >=1 genuinely mid-flight injection
        out[0] = dataclasses.replace(out[0], graceful=False)
    if args.elastic_to:
        # the last scenario becomes the elastic reshard trigger
        last = out[-1]
        out[-1] = Scenario(kind="preempt", step=last.step, node=last.node,
                           graceful=last.graceful,
                           params={"new_sg": args.elastic_to})
    return out


def run(argv=None, on_event=None) -> dict:
    """The drill as the CLI runs it; returns the supervisor's report with
    the goodput summary, the cadence the session held at each change
    (`cadence`), the config, `failed` (the exit checks that failed) and
    `ok`.  `on_event` is the supervisor's hook, called with each fault
    event as it is recorded."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.supervise.run")
    ap.add_argument("--arch", default="opt-125m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--backend", default="reft",
                    choices=["reft", "objstore"])
    ap.add_argument("--sg-size", type=int, default=4)
    ap.add_argument("--snapshot-every", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="/tmp/reft-supervised-ckpt")
    ap.add_argument("--auto-tune", action="store_true",
                    help="MTBF-fed Appendix-A cadence retuning")
    ap.add_argument("--scenarios", type=int, default=5,
                    help="number of seeded scenarios to plan")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kinds", default="",
                    help="comma-separated kind pool for the planner")
    ap.add_argument("--inject", action="append", default=[],
                    help="explicit STEP:KIND[:NODE] (overrides the "
                         "planner; repeatable)")
    ap.add_argument("--elastic-to", type=int, default=0,
                    help="reshard to this sg_size at the final scenario "
                         "(turns it into a preempt -> elastic rebuild)")
    ap.add_argument("--json", default="",
                    help="write the goodput trajectory here")
    ap.add_argument("--min-goodput", type=float, default=0.0,
                    help="fail the run under this goodput fraction")
    args = ap.parse_args(argv)

    from repro_torch.launch.train import resolve_device
    device = resolve_device(args.device)

    import torch

    from repro_torch.api import CheckpointSpec
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.supervise.supervisor import Supervisor
    from repro_torch.train.steps import (init_train_state, make_train_step,
                                         state_to)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = InputShape("cli", args.seq, args.batch, "train")
    state = init_train_state(cfg, 0, device=device)
    ds = SyntheticDataset(cfg, shape, seed=0, device=device)
    step_fn = make_train_step(cfg)

    def advance(st, step):
        st = state_to(st, device)              # restored trees are host
        st, _metrics = step_fn(st, next(ds))
        if device.type == "cuda":
            torch.cuda.synchronize()           # the step's device work
        return st                              # is compute, not a stall

    scenarios = build_scenarios(args, args.sg_size)
    print(f"[supervise] arch={cfg.name} params={cfg.param_count():,} "
          f"device={device} sg={args.sg_size} steps={args.steps} "
          f"scenarios={[(s.step, s.kind) for s in scenarios]}")

    spec = CheckpointSpec(
        backend=args.backend, ckpt_dir=args.ckpt_dir,
        sg_size=args.sg_size,
        snapshot_every_steps=args.snapshot_every,
        checkpoint_every_steps=args.ckpt_every,
        resume=False, auto_tune=args.auto_tune,
    )
    sup = Supervisor(spec, state, advance, scenarios=scenarios,
                     on_event=on_event, log=lambda s: print(s, flush=True))
    out = sup.run(args.steps)
    out.pop("final_state")

    g = out["goodput"]
    print(f"[supervise] failures={out['failures']} "
          f"kinds={out['kinds']} unrecovered={out['unrecovered']} "
          f"goodput={g['goodput_frac']:.3f} "
          f"acct_err={g['accounting_error']:.4f} "
          f"mtbf={out['mtbf_s']:.2f}s "
          f"lam_post={out['lam_node_posterior']:.2e} "
          f"cadence={out['cadence']}")
    for c, s in sorted(g["seconds"].items()):
        print(f"  {c:<17s} {s:8.3f}s  ({g['fractions'][c] * 100:5.1f}%)")

    out["config"] = {
        "arch": cfg.name, "sg_size": args.sg_size,
        "steps": args.steps, "seed": args.seed,
        "backend": args.backend, "device": str(device),
        "scenarios": [dataclasses.asdict(s) for s in scenarios],
    }
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2, default=str)
        print(f"[supervise] wrote {args.json}")

    failed = []
    if out["unrecovered"]:
        failed.append(f"{out['unrecovered']} unrecovered failures")
    bad_exact = [b for b in out["bit_exact_checks"] if b is False]
    if bad_exact:
        failed.append(f"{len(bad_exact)} restores were not byte-exact")
    if not (abs(g["accounting_error"]) <= 0.05):
        failed.append(f"ledger accounting error "
                      f"{g['accounting_error']:.4f} > 5%")
    if g["goodput_frac"] < args.min_goodput:
        failed.append(f"goodput {g['goodput_frac']:.3f} < "
                      f"{args.min_goodput}")
    for msg in failed:
        print(f"FAIL: {msg}")
    out["failed"], out["ok"] = failed, not failed
    return out


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
