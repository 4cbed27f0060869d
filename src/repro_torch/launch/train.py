"""End-to-end training entry point with pluggable fault tolerance (PyTorch).

The counterpart of `repro/launch/train.py`: trains a real model on the
card under a registered `Checkpointer` backend (the paper's REFT stack;
`objstore`, REFT with tier-4 object-store durability; the paper's §6.1
disk baselines `sync_disk` and `async_disk`; or `null`), with optional
fault injection that exercises the recovery ladder mid-run and resumes
training from the recovered state.

  python -m repro_torch.launch.train --arch opt-125m --backend reft \\
      --steps 12 --batch 2 --seq 256 --snapshot-every 2 \\
      --inject 6:software --inject 10:node
  python -m repro_torch.launch.train --arch mamba2-130m --backend reft \\
      --steps 12 --batch 2 --seq 2048 --snapshot-every 2 \\
      --inject 6:software --inject 10:node
  python -m repro_torch.launch.train --arch starcoder2-3b --layers 4 \\
      --backend reft --steps 12 --batch 1 --seq 16384 --snapshot-every 2 \\
      --inject 6:software --inject 10:node
  python -m repro_torch.launch.train --arch opt-125m --backend objstore \\
      --steps 12 --batch 2 --seq 256 --snapshot-every 2 --ckpt-every 4 \\
      --inject 6:software --inject 10:node
  python -m repro_torch.launch.train --arch opt-125m --backend sync_disk \\
      --steps 12 --batch 2 --seq 256 --snapshot-every 2 --inject 6:software

Runs on CUDA unless `--device cpu` asks for the CPU; with no CUDA device
and no `--device cpu` it raises.  `--verify-restores` records the CRC32 of
the whole state at every snapshotted step and checks each restored state
against it, byte for byte.  `--layers N` cuts the depth to N layers and
keeps every width.  `--delta` turns on dirty-delta snapshotting (the
per-bucket digest compare, and on a MoE arch the router's touched-expert
mask as the dirty provider; reft and objstore only),
`--auto-tune` the Appendix-A adaptive cadence, and `--no-reft` is
`--backend null`.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np

# torch is imported inside the functions: the SMP processes start with
# `spawn`, which re-imports this module, and must stay numpy-only


def _load_stats_str(ld) -> str:
    """One-line per-phase load decomposition for resume/recover prints."""
    if ld is None:
        return ""
    out = (f" read={ld.bytes_read / 1e6:.1f}MB"
           f" decoded={ld.decoded_bytes / 1e6:.1f}MB"
           f" read_s={ld.read_seconds:.3f}")
    if ld.h2d_seconds:
        out += f" h2d_s={ld.h2d_seconds:.3f}"
    if ld.resharded:
        out += f" resharded={ld.saved_n}->{ld.target_n}"
    return out


@contextlib.contextmanager
def _touched_experts(num_experts: int):
    """The router records the experts it picks (`moe.TOUCHED`) for the
    block's steps."""
    from repro_torch.models.moe import TOUCHED
    TOUCHED.enable(num_experts)
    try:
        yield
    finally:
        TOUCHED.disable()


def _expert_provider(fspec, log):
    """The MoE dirty provider (`expert_dirty_ranges` over the router's
    touched-expert mask, consumed at each flight), logging each call's
    touched experts and dirty bytes into `log`."""
    from repro_torch.core.delta import expert_dirty_ranges, ranges_bytes
    from repro_torch.models.moe import TOUCHED

    def provider():
        touched = TOUCHED.consume()
        ranges = expert_dirty_ranges(fspec, touched)
        log.append({"touched": int(touched.sum()),
                    "dirty_bytes": ranges_bytes(ranges),
                    "total_bytes": fspec.total_bytes})
        return ranges
    return provider


def resolve_device(name: str):
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: repro_torch runs on the card; "
            "pass --device cpu to run on the CPU instead")
    return dev


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="opt-125m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths kept)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--backend", default="reft",
                    choices=["reft", "objstore", "sync_disk", "async_disk",
                             "null"])
    ap.add_argument("--sg-size", type=int, default=4)
    ap.add_argument("--snapshot-every", type=int, default=2)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default="/tmp/reft-train-ckpt")
    ap.add_argument("--resume", action="store_true",
                    help="restore-on-entry from ckpt-dir if possible")
    ap.add_argument("--auto-tune", action="store_true",
                    help="Appendix-A adaptive snapshot cadence")
    ap.add_argument("--blocking-persist", action="store_true",
                    help="run cadence persists inline (the pre-overlap "
                         "behavior) instead of fire-and-poll")
    ap.add_argument("--delta", action="store_true",
                    help="dirty-delta snapshotting: the per-bucket digest "
                         "compare skips buckets whose bytes did not change; "
                         "on a MoE arch the router's touched-expert mask "
                         "feeds the dirty provider")
    ap.add_argument("--device-encode", default="auto",
                    choices=["auto", "on", "off"],
                    help="bucket encode on the device (auto: when the "
                         "state lives on the card)")
    ap.add_argument("--inject", action="append", default=[],
                    help="STEP:KIND[:NODE]  (kind: software|node|smp|"
                         "laggard|corrupt-stripe|slow-persist|preempt)")
    ap.add_argument("--graceful-inject", action="store_true",
                    help="drain in-flight saves before each injection "
                         "(default: mid-flight, like a real failure)")
    ap.add_argument("--verify-restores", action="store_true",
                    help="check every restored state byte for byte "
                         "against the state saved at that step")
    ap.add_argument("--no-reft", action="store_true",
                    help="legacy alias for --backend null")
    args = ap.parse_args(argv)
    if args.no_reft:
        args.backend = "null"
    return ap, args


def run(argv=None) -> dict:
    """Train as the CLI does; returns a report: losses, per-step seconds,
    recoveries [{tier, step, bit_exact, kind, seconds, clean, flights}]
    (under REFT, each member's clean steps as the ladder read them and
    its flights as its engine saw them then; see `RestoreResult`),
    snapshot CRCs (of every step some member launched), backend stats
    (persists, overlap, uploads, scrub passes among them, read before
    the session closes), the step of every persist that completed, the
    session's closing persist included (`persisted_steps`), the disk
    backends' last save split into phases, the launches of each CUDA
    kernel during the run, and under `--delta` on a MoE arch each call of
    the touched-expert provider (`expert_flights`: the experts touched
    since the last call and the bytes it ruled dirty)."""
    ap, args = parse_args(argv)
    device = resolve_device(args.device)

    from repro_torch.api import CheckpointSession, CheckpointSpec
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.recovery import RecoveryError
    from repro_torch.core.treebytes import state_crc
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.kernels import launch_counts
    from repro_torch.models.model import _stack_period
    from repro_torch.supervise.inject import parse_scenario
    from repro_torch.train.steps import (init_train_state, make_train_step,
                                         state_to)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        if not 1 <= args.layers <= cfg.num_layers:
            ap.error(f"--layers must be in 1..{cfg.num_layers}")
        period = _stack_period(cfg)[0]
        if args.layers % period:
            ap.error(f"--layers must be a multiple of {cfg.name}'s period "
                     f"of {period} layers")
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    shape = InputShape("cli", args.seq, args.batch, "train")
    injections = {}
    for item in args.inject:
        try:
            sc = parse_scenario(item, default_node=-1)
        except ValueError as e:
            ap.error(str(e))
        injections[sc.step] = sc
    if injections and args.backend == "null":
        ap.error("--inject needs a backend that can restore (not null)")
    if args.delta and args.backend not in ("reft", "objstore"):
        ap.error("--delta needs the reft backend family")

    print(f"[train] arch={cfg.name} layers={cfg.num_layers} "
          f"params={cfg.param_count():,} "
          f"batch={args.batch}x{args.seq} backend={args.backend} "
          f"device={device}" + (" delta" if args.delta else ""))
    state = init_train_state(cfg, 0, device=device)
    ds = SyntheticDataset(cfg, shape, seed=0, device=device)
    step_fn = make_train_step(cfg)

    spec = CheckpointSpec(
        backend=args.backend,
        ckpt_dir=args.ckpt_dir,
        sg_size=args.sg_size,
        snapshot_every_steps=args.snapshot_every,
        checkpoint_every_steps=args.ckpt_every,
        resume=args.resume,
        auto_tune=args.auto_tune,
        options={"device_encode": args.device_encode,
                 **({"persist_blocking": True} if args.blocking_persist
                    else {}),
                 **({"delta": True} if args.delta else {})},
    )

    report = {"losses": [], "step_seconds": [], "step_beside_flight": [],
              "recoveries": [], "snapshot_crcs": {}, "stats": {},
              "engine_stats": [], "disk_times": None,
              "expert_flights": []}
    launches0 = launch_counts()
    saved_crc = report["snapshot_crcs"]
    t0 = time.time()
    step = int(state["step"])

    def restored(res, what, seconds=None):
        bit_exact = None
        if args.verify_restores and what == "recover":
            bit_exact = state_crc(res.state) == saved_crc.get(res.step)
        print(f"[{what}] tier={res.tier} step={res.step}"
              + ("" if bit_exact is None else f" bit_exact={bit_exact}")
              + "".join(f" in_air=node{m}@{s}"
                        for m, f in sorted((res.flights or {}).items())
                        for s in f["in_air"])
              + _load_stats_str(res.load))
        report["recoveries"].append({"tier": res.tier, "step": res.step,
                                     "bit_exact": bit_exact, "kind": what,
                                     "seconds": seconds, "clean": res.clean,
                                     "flights": res.flights})
        if bit_exact is False:
            raise RuntimeError(f"restored state at step {res.step} differs "
                               f"from the state saved at that step")
        ds.restore(res.extra_meta)
        return state_to(res.state, device), res.step

    moe_delta = args.delta and cfg.num_experts
    with CheckpointSession(spec, state) as sess, \
            (_touched_experts(cfg.num_experts) if moe_delta
             else contextlib.nullcontext()):
        if moe_delta and hasattr(sess.checkpointer, "set_dirty_provider"):
            sess.checkpointer.set_dirty_provider(_expert_provider(
                sess.checkpointer.group.engines[0].spec,
                report["expert_flights"]))
        if sess.restored is not None:
            state, step = restored(sess.restored, "resume")
        while step < args.steps:
            group = getattr(sess.checkpointer, "group", None)
            report["step_beside_flight"].append(
                group is not None and any(e.in_flight()
                                          for e in group.engines))
            t_step = time.perf_counter()
            batch = next(ds)
            state, metrics = step_fn(state, batch)
            step += 1
            report["losses"].append(float(metrics["loss"]))
            did = sess.after_step(state, step, extra_meta=ds.state())
            report["step_seconds"].append(time.perf_counter() - t_step)
            if args.verify_restores and did["launched"]:
                saved_crc[step] = state_crc(state)

            if step in injections:
                sc = injections.pop(step)
                kind = sc.kind
                node = sc.node if sc.node >= 0 \
                    else (0 if kind == "software" else 1)
                print(f"[inject] {kind} failure at step {step} "
                      f"(node {node}"
                      + ("" if args.graceful_inject else ", mid-flight")
                      + ")")
                sess.inject(kind, node=node,
                            graceful=args.graceful_inject,
                            **sc.merged_params())
                if kind in ("laggard", "slow-persist"):
                    continue           # perf faults: nothing to restore
                if kind == "preempt":
                    # ride out the grace window; health() ticks the
                    # deadline and hard-fails the node when it expires
                    deadline = time.monotonic() + 5.0
                    while node not in sess.health().get("preempted",
                                                        [node]):
                        if time.monotonic() > deadline:
                            ap.error("preempt grace window never expired")
                        # deadline-bounded grace-window poll in the CLI
                        # harness (the sim has no event to wait on)
                        # analyze: ok ANZ007
                        time.sleep(0.05)
                t_restore = time.perf_counter()
                try:
                    res = sess.restore()
                except RecoveryError as e:
                    ap.error(f"injected {kind} failure at step {step} is "
                             f"unrecoverable: {e} (no completed save yet — "
                             f"lower --snapshot-every or inject later)")
                state, step = restored(res, "recover",
                                       time.perf_counter() - t_restore)

            if step % 10 == 0 or step == args.steps:
                print(f"  step {step:5d} loss {report['losses'][-1]:.4f} "
                      f"({(time.time()-t0)/max(step,1):.2f}s/step)",
                      flush=True)
        sess.drain()               # join async persists + collect events
        st = sess.stats()
        report["stats"] = st
        if hasattr(sess.checkpointer, "group"):
            report["engine_stats"] = [dict(e.stats) for e in
                                      sess.checkpointer.group.engines]
        if hasattr(sess.checkpointer, "writer"):
            report["disk_times"] = dataclasses.asdict(
                sess.checkpointer.writer.last_times)
        # engine-side timing when the backend exposes it (async launches
        # make the trainer-side snapshot_seconds near-zero by design)
        snaps = st.get("engine_snapshots") or st.get("snapshot", 0)
        secs = st.get("engine_seconds", st.get("snapshot_seconds", 0.0))
        print(f"[{args.backend}] snapshots={snaps} "
              f"persists={st.get('persist', 0)} "
              f"persist_inflight={st.get('persist_inflight', 0)} "
              f"persist_overlap_s="
              f"{st.get('persist_overlap_seconds', 0.0):.3f} "
              f"restores={st.get('restore', 0)} "
              f"avg_snapshot_s={secs/max(snaps, 1):.3f} "
              f"device_encode="
              f"{any(e.get('device_encode') for e in report['engine_stats'])} "
              f"degraded={sess.degraded}")
        if st.get("persist_upload_bytes"):
            print(f"[{args.backend}] uploads="
                  f"{st['persist_upload_bytes'] / 1e6:.1f}MB "
                  f"upload_s={st.get('persist_upload_seconds', 0.0):.3f} "
                  f"retries={st.get('persist_upload_retries', 0)} "
                  f"throttle_s="
                  f"{st.get('persist_throttle_seconds', 0.0):.3f}")
        if st.get("delta_flights") or st.get("keyframe_flights"):
            print(f"[{args.backend}] "
                  f"delta_flights={st.get('delta_flights', 0)} "
                  f"keyframes={st.get('keyframe_flights', 0)} "
                  f"skipped_buckets={st.get('skipped_buckets', 0)} "
                  f"base_misses={st.get('delta_base_misses', 0)}")
        if report["expert_flights"]:
            clean = sum(e.get("provider_clean_buckets", 0)
                        for e in report["engine_stats"])
            print(f"[{args.backend}] expert_provider calls="
                  f"{len(report['expert_flights'])} touched="
                  f"{[f['touched'] for f in report['expert_flights']]} "
                  f"dirty_bytes="
                  f"{sorted({f['dirty_bytes'] for f in report['expert_flights']})}"
                  f" of {report['expert_flights'][0]['total_bytes']} "
                  f"provider_clean_buckets={clean}")
        if st.get("scrub_passes"):
            print(f"[{args.backend}] scrub_passes={st['scrub_passes']} "
                  f"families={st.get('scrub_families', 0)} "
                  f"corrupt={st.get('scrub_corrupt', 0)} "
                  f"repaired={st.get('scrub_repaired', 0)}")
    # the session's closing persist lands after `stats` was read
    report["persisted_steps"] = [e.step for e in sess.events
                                 if e.kind == "persist"]
    report["kernel_launches"] = {k: v - launches0[k]
                                 for k, v in launch_counts().items()}
    print("[kernels] " + " ".join(f"{k}={v}" for k, v in
                                  report["kernel_launches"].items()))
    losses = report["losses"]
    report["wall_seconds"] = time.time() - t0
    if not losses:
        print(f"[done] steps={step} (resumed past --steps; nothing to run) "
              f"wall={report['wall_seconds']:.1f}s")
        return report
    print(f"[done] steps={step} final_loss={losses[-1]:.4f} "
          f"first_loss={losses[0]:.4f} wall={report['wall_seconds']:.1f}s")
    if not np.isfinite(losses).all():
        raise RuntimeError("loss diverged")
    return report


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
