"""Quickstart: train a tiny model behind the unified checkpointing facade.

The twin of `examples/quickstart.py`. Any registered backend drops in
with one line: swap "reft" for "sync_disk" / "async_disk" and the same
loop runs against a disk baseline.

    python -m repro_torch.examples.quickstart [--backend reft]   # the card
    python -m repro_torch.examples.quickstart --device cpu

Runs on CUDA unless `--device cpu` asks for the CPU; with no CUDA device
and no `--device cpu` it raises. Snapshot files go to a temporary
directory unless `--ckpt-dir` names one.
"""
import argparse
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--backend", default="reft",
                    choices=["reft", "sync_disk", "async_disk"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    # torch stays out of the module body: the reft backend's SMP processes
    # start with `spawn` and import this module again
    import torch

    from repro_torch.api import CheckpointSession, CheckpointSpec
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.treebytes import host_bytes, leaf_arrays
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.launch.train import resolve_device
    from repro_torch.train.steps import (init_train_state, make_train_step,
                                         with_step_boundary)

    device = resolve_device(args.device)
    cfg = get_config("qwen3-8b").reduced()        # 2-layer smoke variant
    shape = InputShape("demo", 64, 2, "train")
    state = init_train_state(cfg, 0, device=device)
    ds = SyntheticDataset(cfg, shape, device=device)
    # this loop never calls sess.after_step, so the wrapper is what ticks
    # the HASC gate: in-flight snapshot pipelines yield at step boundaries
    step_fn = with_step_boundary(make_train_step(cfg))

    with tempfile.TemporaryDirectory(prefix="reft-quickstart-") as tmp:
        # one sharding group of 4 simulated nodes (for reft: one real SMP
        # process per member)
        spec = CheckpointSpec(backend=args.backend,
                              ckpt_dir=args.ckpt_dir or tmp, sg_size=4,
                              resume=False)
        with CheckpointSession(spec, state) as sess:
            for _ in range(6):
                state, metrics = step_fn(state, next(ds))
                step = int(state["step"])
                sess.snapshot(state, step, extra_meta=ds.state(), wait=True)
                print(f"step {step}: loss={float(metrics['loss']):.4f} "
                      f"(snapshot clean @ {step})")

            # simulate losing a whole node: the reft backend RAIM5-decodes
            # its shard from parity; disk backends reload the last save
            sess.inject("node", node=2)
            res = sess.restore()
            same = all(torch.equal(torch.from_numpy(host_bytes(a)),
                                   torch.from_numpy(host_bytes(b)))
                       for a, b in zip(leaf_arrays(res.state),
                                       leaf_arrays(state)))
            print(f"recovered via {res.tier} at step {res.step}; "
                  f"bit-exact: {same}")
            if not (same and res.step == step):
                raise RuntimeError(f"restore at step {res.step} of {step}, "
                                   f"bit-exact {same}")
        print("events:", [f"{e.kind}@{e.step}" for e in sess.events][-6:])


if __name__ == "__main__":
    main()
