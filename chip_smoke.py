"""Chip smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero:
  1. device facts: nvidia-smi name and power limit, torch's device name,
     and room in /dev/shm for the snapshot managers' buffers;
  2. build every CUDA kernel from the sources (nvcc, sm_90a), timed;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, bit-exact, with CUDA-event times;
  4. the main path at full width: `repro_torch.launch.train` on opt-125m
     with REFT, a software failure (recovered from memory) and a node
     failure (recovered by a RAIM5 decode), every restored state checked
     byte for byte; the kernels' launch counts come from this run only;
  5. a `kernels` JSON line, the card's name and power limit, and as the
     last line {"ok": true, "device": {...}}.

Exits non-zero without a result when no CUDA device is present, or when
run outside a checkout of the repository (it needs `src/repro_torch`).
The module body stays import-light: the snapshot managers start with
`spawn` and re-import this file.
"""
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

ARGV = ["--arch", "opt-125m", "--backend", "reft", "--sg-size", "4",
        "--steps", "12", "--batch", "2", "--seq", "256",
        "--snapshot-every", "2", "--inject", "6:software",
        "--inject", "10:node", "--device", "cuda", "--verify-restores"]
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
# GPU sleep (cycles, ~10 ms) that outlasts the host's enqueue of one timing
# trial, so kernel times exclude the Python wrapper's per-call cost
HOLD_CYCLES = 20_000_000
MIB4 = 4 << 20
# (label, k, nbytes, want_crc on the main path)
ENCODE_CASES = [
    ("own bucket 4 MiB", 1, MIB4, True),
    ("parity bucket 4 MiB", 3, MIB4, False),
    ("own tail bucket", 1, 3_546_754, True),           # nbytes % 4 == 2
    ("tail bucket, nbytes % 4 == 3", 1, 3_546_755, True),
    ("single-digest bucket", 1, 262_141, True),        # 65,536 lanes
]


def phase(name):
    print(f"== {name}", flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def device_facts(torch):
    from repro_torch.configs import get_config
    from repro_torch.core.smp import NodeLayout
    smi = smi_line()
    print(f"nvidia-smi: {smi}")
    print(f"torch: {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    cfg = get_config("opt-125m")
    # params in bf16 plus two fp32 moments; step, opt step, 2-word rng
    state_bytes = cfg.param_count() * (2 + 4 + 4) + 4 + 4 + 8
    n = 4
    need = n * 3 * NodeLayout(n, state_bytes).buf_bytes + n * 8 * MIB4
    free = shutil.disk_usage("/dev/shm").free
    print(f"/dev/shm: free {free} B, need {need} B "
          f"(state {state_bytes} B, {n} SMPs x 3 buffers + rings)")
    if free < need:
        raise SystemExit(f"/dev/shm too small: free {free} B < need {need} B")
    return smi, state_bytes


def build_kernels():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    dt = time.perf_counter() - t0
    for name, path in libs.items():
        print(f"built {name}: {os.path.relpath(path, HERE)}")
    print(f"kernel build: {dt:.3f} s ({len(libs)} sources, parallel nvcc)")


def _cuda_ms(torch, fn, reps=20, trials=7, hold_cycles=0):
    """Median over trials of CUDA-event time per call (reps per trial).
    With `hold_cycles`, a GPU sleep holds the stream while the host
    enqueues the calls, so the events bracket back-to-back kernels (device
    time); without it they also take in the host's enqueue time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hold_cycles:
            torch.cuda._sleep(hold_cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _host_ms(torch, fn, trials=3):
    times = []
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_encode_bucket(torch):
    """encode_bucket against encode_bucket_plain on the card."""
    import numpy as np

    from repro_torch.kernels import stage
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    max_err = 0
    for label, k, nbytes, main_crc in ENCODE_CASES:
        n = -(-nbytes // stage.LANE_BYTES) * (stage.LANE_BYTES // 4)
        raw = torch.randint(0, 256, (k, 4 * n), generator=gen,
                            dtype=torch.uint8, device="cuda")
        raw[:, nbytes:] = 0
        blocks = raw.view(torch.uint32)
        out, crc = stage.encode_bucket(blocks, nbytes=nbytes)
        pout, pcrc = stage.encode_bucket_plain(blocks, nbytes=nbytes)
        torch.cuda.synchronize()
        lanes = out.view(torch.int32).cpu().numpy().view(np.uint32)
        plain = pout.view(torch.int32).cpu().numpy().view(np.uint32)
        digests = crc.view(torch.int32).cpu().numpy().view(np.uint32)
        pdigests = pcrc.view(torch.int32).cpu().numpy().view(np.uint32)
        err = max(int(np.max(np.abs(lanes.astype(np.int64)
                                    - plain.astype(np.int64)))),
                  int(np.max(np.abs(digests.astype(np.int64)
                                    - pdigests.astype(np.int64)))))
        want = zlib.crc32(plain.view(np.uint8)[:nbytes].tobytes())
        got = stage.bucket_crc(digests, nbytes)
        if err or got != want:
            raise AssertionError(f"encode_bucket {label}: max_abs_err={err} "
                                 f"crc {got:#x} != zlib {want:#x}")
        if not main_crc:           # the main path's parity call: no CRC
            out2, crc2 = stage.encode_bucket(blocks, nbytes=nbytes,
                                             want_crc=False)
            torch.cuda.synchronize()
            if not torch.equal(out2, out) or crc2.view(torch.int32).any():
                raise AssertionError(f"encode_bucket {label}: want_crc=False "
                                     f"disagrees")
        max_err = max(max_err, err)
        launch = lambda: stage.encode_bucket(             # noqa: E731
            blocks, nbytes=nbytes, want_crc=main_crc)
        ms = _cuda_ms(torch, launch, hold_cycles=HOLD_CYCLES)
        call_ms = _cuda_ms(torch, launch)
        plain_ms = _host_ms(torch, lambda: stage.encode_bucket_plain(
            blocks, nbytes=nbytes, want_crc=main_crc))
        moved = (k + 1) * 4 * n
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        rows.append({"case": label, "k": k, "n_lanes": n, "nbytes": nbytes,
                     "tiles": int(crc.numel()), "want_crc": main_crc,
                     "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bytes": moved})
        print(f"encode_bucket {label}: k={k} lanes={n} tiles={crc.numel()} "
              f"crc={main_crc} ms={ms:.5f} call_ms={call_ms:.5f} "
              f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.5f} "
              f"({ms / bound_ms:.1f}x bound) bit-exact")
    return rows, max_err


def main_path(torch):
    from repro_torch.kernels import stage
    from repro_torch.launch import train
    ckpt = tempfile.mkdtemp(prefix="reft-chip-smoke-")
    try:
        stage.encode_bucket.launches = 0
        t0 = time.perf_counter()
        rep = train.run(ARGV + ["--ckpt-dir", ckpt])
        wall = time.perf_counter() - t0
        launches = stage.encode_bucket.launches
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    tiers = [(r["tier"], r["bit_exact"]) for r in rep["recoveries"]]
    if tiers != [("in-memory", True), ("raim5", True)]:
        raise AssertionError(f"recoveries {rep['recoveries']}: want "
                             f"in-memory then raim5, both byte-exact")
    if not all(e.get("device_encode") for e in rep["engine_stats"]):
        raise AssertionError("device encode was off on the main path")
    if launches <= 0:
        raise AssertionError("encode_bucket never launched on the main path")
    st = rep["stats"]
    flights = st.get("engine_snapshots", 0)
    launched = len(rep["snapshot_crcs"])       # SG snapshots launched
    steps = rep["step_seconds"]
    print(f"main path: wall {wall:.3f} s, {len(steps)} steps, "
          f"median step {statistics.median(steps):.4f} s, step seconds "
          + json.dumps([round(x, 4) for x in steps]))
    print(f"snapshots: {launched} SG snapshots launched, {flights} member "
          f"flights completed, avg flight "
          f"{st.get('engine_seconds', 0.0) / max(flights, 1):.4f} s, "
          f"levels l1={st.get('engine_l1_seconds', 0.0):.3f} "
          f"l2={st.get('engine_l2_seconds', 0.0):.3f} "
          f"l3={st.get('engine_l3_seconds', 0.0):.3f} s")
    print(f"encode_bucket launches on the main path: {launches} "
          f"({launches / max(launched, 1):.1f} per SG snapshot)")
    print("snapshot CRCs: " + json.dumps(
        {str(k): f"{v:#010x}" for k, v in rep["snapshot_crcs"].items()}))
    print(f"recoveries: {json.dumps(rep['recoveries'])}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    phase("1 device facts")
    smi, _ = device_facts(torch)
    phase("2 kernel build")
    build_kernels()
    phase("3 kernels against their plain versions")
    rows, max_err = check_encode_bucket(torch)
    phase("4 main path at full width")
    launches = main_path(torch)
    phase("5 summary")
    own = rows[0]
    kernels = [{"name": "encode_bucket", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/encode_bucket.cu",
                "replaces": "src/repro/kernels/stage.py:159",
                "launches": launches, "max_abs_err": max_err,
                "ms": own["ms"], "plain_ms": own["plain_ms"],
                "bound_ms": own["bound_ms"], "bound_by": "bytes",
                "library_ms": None, "ok": True}]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
