"""Run one cell of the benchmark on the card and print its result line.

    python3 perfbench/run.py --workload mamba2-130m.b16.save --seed 7 \\
        --seconds 10 --trace 0

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` also
`breakdown`, and last `checks`: each number compared, beside its limit
(also the last lines of standard error). Without a CUDA device, or with
fewer than the cell asks for, it exits with code 2 and prints no result;
so it does when the process holds JAX or the JAX package once the
window has closed.

The SMP processes of a session start with `spawn` and import this file
again: nothing but the standard library is imported at module level.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """When this process started, on the wall clock (/proc on Linux; the
    import of this module elsewhere)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text()
                    .rsplit(")", 1)[1].split()[19])
        since_boot = ticks / os.sysconf("SC_CLK_TCK")
        now_boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        return time.time() - (now_boot - since_boot)
    except (OSError, ValueError, IndexError, AttributeError):
        return time.time()


T_START = process_start()


def forbidden_modules(names=None) -> list:
    """Top-level names among `names` (sys.modules') that are JAX or the
    JAX package, compared whole (`repro_torch` is not `repro`)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def setup_environment():
    """Build and kernel caches at fixed paths inside the checkout; the
    program on the path; JAX kept out of libraries that would load it."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_environment()
    from perfbench import harness, spec
    bench = spec.benchmark(ROOT)
    chips = spec.cell(args.workload)["chips"]
    import torch
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"perfbench: cell {args.workload} needs {chips} CUDA "
              f"device(s); this process sees {seen}", file=sys.stderr)
        return 2
    smi = power_limit()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}",
          file=sys.stderr)
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process holds {bad} (JAX or the JAX "
              f"package); no result", file=sys.stderr)
        return 2
    rec = out["record"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"],
            "metrics": harness.metric_values(bench, args.workload,
                                             bool(args.trace), rec),
            "device": device}
    if args.trace:
        tr = rec["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["stretch_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = out["checks"]
    w = rec["window"]
    print(f"[window] {w['steps']} steps in {w['seconds']:.3f} s, setup "
          f"{rec['setup_s']:.3f} s, {len(w['restores'])} restores; losses "
          f"program {out['losses']['program']} reference "
          f"{out['losses']['reference']}", file=sys.stderr)
    for r in w["restores"]:
        print(f"[restore] failed at {r['failed_at']}, restored "
              f"{r['restored']} ({r['tier']}) in {r['seconds']:.3f} s, "
              f"{r['bytes']} bytes differ", file=sys.stderr)
    print("[steps] " + " ".join(f"{1e3 * s:.0f}{f}" for s, f in zip(
        w["step_seconds"], w["launches"])) + " (ms; S: every member "
        "launched a flight, P: some, -: none)", file=sys.stderr)
    print("[numbers] " + " ".join(f"{k}={v!r}" for k, v in
                                  out["numbers"].items()
                                  if k not in out["checks"])
          + " (not compared)", file=sys.stderr)
    for name, (value, limit) in out["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
