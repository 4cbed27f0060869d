"""Multi-process failure drill: 4 real node processes, real SIGKILLs.

The twin of `examples/failure_recovery.py`: the paper's elastic workflow
(Figure 2): healthy lockstep training -> software failure (trainer dies,
SMP survives) -> in-memory resume -> node failure -> RAIM5 decode ->
elastic replacement -> a double failure falling back to REFT-Ckpt. The
cluster is configured by the same `CheckpointSpec` the facade uses, and
every recovery goes through the shared three-tier ladder. The node
processes hold numpy state (no device); the snapshot files go to a
temporary directory unless `--ckpt-dir` names one.

    python -m repro_torch.examples.failure_recovery
"""
import argparse
import tempfile


def bitexact(a, b):
    import numpy as np

    from repro_torch.core.treebytes import host_bytes, leaf_arrays
    return all(np.array_equal(host_bytes(x), host_bytes(y))
               for x, y in zip(leaf_arrays(a), leaf_arrays(b)))


def drill(ckpt_dir):
    # imported here: the node processes start with `spawn` and import
    # this module again
    from repro_torch.api import CheckpointSpec
    from repro_torch.core.cluster import LocalCluster

    spec = CheckpointSpec(backend="reft", ckpt_dir=ckpt_dir, sg_size=4,
                          snapshot_every_steps=1, bucket_bytes=1 << 20)
    c = LocalCluster(4, seed=1, nbytes=1 << 18, spec=spec)
    tiers = []
    try:
        c.run_rounds(5)
        print("== software failure: SIGKILL trainer on node 1")
        c.kill_trainer(1)
        tiers.append(report(c))
        c.restart_node(1, tiers[-1][0])

        c.run_rounds(3)
        c.checkpoint()                       # REFT-Ckpt tier persists shards
        print("== node failure: SIGKILL trainer+SMP on node 2, wipe memory")
        c.kill_node(2)
        tiers.append(report(c))
        c.restart_node(2, tiers[-1][0])

        c.run_rounds(2)
        print("== double failure in one SG: nodes 0 and 3")
        c.kill_node(0)
        c.kill_node(3)
        tiers.append(report(c))
    finally:
        c.close()
    return [(tier, ok) for _, tier, ok in tiers]


def report(c):
    state, step, tier = c.recover()
    ok = bitexact(state, c.expected_state(step))
    print(f"   recovered via {tier} @ step {step}, bit-exact={ok}")
    return state, tier, ok


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.failure_recovery")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="reft-drill-") as tmp:
        got = drill(args.ckpt_dir or tmp)
    if not all(ok for _, ok in got):
        raise RuntimeError(f"a restore was not bit-exact: {got}")


if __name__ == "__main__":
    main()
