"""Chip smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero:
  1. device facts: nvidia-smi name and power limit, torch's device name,
     and room in /dev/shm for the snapshot managers' buffers;
  2. build every CUDA kernel from the sources (nvcc, sm_90a), timed;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it, with CUDA-event times: encode_bucket
     bit-exact; the SSD scan's forward and backward kernels against the
     plain chunked scan and its autograd (fp32, TF32 off), once with a
     zero and once with a random initial state; the sliding-window flash
     attention's forward and backward kernels against the plain flash
     attention and its autograd, in fp32 and in bf16, at starcoder2-3b's
     shape and at gemma3-4b's head shape (local and global window), with
     SDPA's memory-efficient attention timed beside them as a yardstick;
  4. the main paths at full width, each through `repro_torch.launch.train`
     with REFT, a software failure (recovered from memory) and a node
     failure (recovered by a RAIM5 decode), every restored state checked
     byte for byte: opt-125m (seq 256), mamba2-130m (seq 2048, the SSD
     kernels in every layer), then starcoder2-3b (4 of its 30 layers, seq
     16384, batch 1, the swa_flash kernels in every layer); the launch
     counts are set to 0 just before each run and read just after it;
  5. a `kernels` JSON line, the card's name and power limit, and as the
     last line {"ok": true, "device": {...}}.

Exits non-zero without a result when no CUDA device is present, or when
run outside a checkout of the repository (it needs `src/repro_torch`).
The module body stays import-light: the snapshot managers start with
`spawn` and re-import this file.
"""
import json
import math
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

RUN_ARGS = ["--backend", "reft", "--sg-size", "4", "--steps", "12",
            "--snapshot-every", "2",
            "--inject", "6:software", "--inject", "10:node",
            "--device", "cuda", "--verify-restores"]
# (arch, seq, batch, layers (None: full depth), kernels that must launch
# on that path). starcoder2-3b's depth is cut to 4 of 30 layers: at full
# depth its REFT state (43.1 GB) would not fit three times on the card
# (snapshots in flight hold the old state while the step builds the new)
# nor four SMPs' buffers in /dev/shm; every width is kept.
PATHS = [("opt-125m", 256, 2, None, ("encode_bucket",)),
         ("mamba2-130m", 2048, 2, None,
          ("encode_bucket", "ssd_scan", "ssd_scan_bwd")),
         ("starcoder2-3b", 16384, 1, 4,
          ("encode_bucket", "swa_flash", "swa_flash_bwd"))]
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12                 # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989.4e12              # H100 SXM bf16 dense tensor cores
# the swa_flash shapes: (label, B, S, KV, G, hd, window, causal, on path)
SWA_CASES = [("starcoder2-3b", 1, 16384, 2, 12, 128, 4096, True, True),
             ("gemma3-4b local", 1, 8192, 4, 2, 256, 1024, True, False),
             ("gemma3-4b global", 1, 8192, 4, 2, 256, None, True, False)]
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


def _path_config(arch, layers):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def device_facts(torch):
    from repro_torch.core.smp import NodeLayout
    smi = smi_line()
    print(f"nvidia-smi: {smi}")
    print(f"torch: {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    # params in bf16 (Mamba2's A_log, dt_bias, D_skip in fp32) plus two
    # fp32 moments; step, opt step, 2-word rng, at the depth each path
    # runs.  The larger state counts.
    sizes = {}
    for arch, _, _, layers, _ in PATHS:
        cfg = _path_config(arch, layers)
        n_par = cfg.param_count()
        f32 = 3 * cfg.ssm_heads * cfg.num_layers if cfg.family == "ssm" else 0
        sizes[arch] = (n_par - f32) * 2 + f32 * 4 + n_par * 8 + 4 + 4 + 8
    state_bytes = max(sizes.values())
    print("state bytes: " + json.dumps(sizes))
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


def _ssd_shape():
    """B, S, H, P, N, chunk of mamba2-130m's SSD core on its path."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-130m")
    seq, batch = {arch: (s, b) for arch, s, b, _, _ in PATHS}["mamba2-130m"]
    return (batch, seq, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssd_chunk)


def _ssd_inputs(torch, gen, with_h0):
    """SSD inputs as ssm_block makes them, with Mamba2's initial ranges
    (A in [-16, -1], dt in [1e-3, 1e-1]; arXiv:2405.21060): a = dt A and
    u = x dt, dt log-uniform per head times lognormal noise per step; x,
    B, C, h0 and the cotangents standard normal."""
    B, S, H, P, N, _ = _ssd_shape()
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa
    un = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(  # noqa: E731
        *s, generator=gen, device="cuda")
    A = -un(1.0, 16.0, H)
    dt = torch.exp(un(math.log(1e-3), math.log(1e-1), H) + 0.5 * rn(B, S, H))
    return {"u": (rn(B, S, H, P) * dt[..., None]).contiguous(),
            "a": (dt * A).contiguous(), "Bm": rn(B, S, N), "Cm": rn(B, S, N),
            "h0": rn(B, H, P, N) if with_h0 else None,
            "dy": rn(B, S, H, P), "dhf": rn(B, H, P, N)}


def check_ssd(torch):
    """The SSD forward and backward kernels against the plain chunked scan
    and its autograd, at mamba2-130m's shapes. Forward: atol 5e-4, rtol
    1e-3 (tests/test_kernels.py's); backward: max |diff| <= 1e-3 max |ref|
    for each gradient. The fp64 plain scan is printed beside them as the
    yardstick of both fp32 versions."""
    from repro_torch.kernels import ssd_scan as K
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    B, S, H, P, N, Q = _ssd_shape()
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {"fwd": 0.0, "bwd": 0.0}
    for case in ("h0 zero", "h0 random"):
        x = _ssd_inputs(torch, gen, case == "h0 random")
        names = ["u", "a", "Bm", "Cm"] + (["h0"] if x["h0"] is not None
                                          else [])
        y, hf, hs = K.ssd_scan_fwd(x["u"], x["a"], x["Bm"], x["Cm"],
                                   x["h0"], chunk=Q)
        grads = K.ssd_scan_bwd(x["dy"], x["dhf"], x["u"], x["a"], x["Bm"],
                               x["Cm"], hs, chunk=Q)
        torch.cuda.synchronize()
        refs = {}
        for dt in (torch.float32, torch.float64):
            leaves = [x[k].to(dt).requires_grad_(True) for k in names]
            h0 = leaves[4] if len(leaves) == 5 else None
            yp, hfp = K.ssd_scan_plain(*leaves[:4], h0, chunk=Q)
            gp = torch.autograd.grad((yp, hfp), leaves,
                                     (x["dy"].to(dt), x["dhf"].to(dt)))
            refs[dt] = (yp.detach(), hfp.detach(), gp)
        yp, hfp, gp = refs[torch.float32]
        y64, hf64, g64 = refs[torch.float64]
        for got, want, w64, what in ((y, yp, y64, "y"),
                                     (hf, hfp, hf64, "h_final")):
            d = (got - want).abs().max().item()
            ok = torch.allclose(got, want, atol=5e-4, rtol=1e-3)
            print(f"ssd_scan {case} {what}: max|diff| {d:.3e} "
                  f"(max|ref| {want.abs().max().item():.3e}); vs fp64: "
                  f"kernel {(got - w64).abs().max().item():.3e}, plain "
                  f"{(want - w64).abs().max().item():.3e}; allclose "
                  f"(atol 5e-4, rtol 1e-3) {ok}")
            if not ok:
                raise AssertionError(f"ssd_scan {case} {what} disagrees")
            err["fwd"] = max(err["fwd"], d)
        for name, got, want, w64 in zip(names, grads, gp, g64):
            d = (got - want).abs().max().item()
            top = want.abs().max().item()
            print(f"ssd_scan_bwd {case} d{name}: max|diff| {d:.3e} "
                  f"(max|ref| {top:.3e}, ratio {d / top:.2e}); vs fp64: "
                  f"kernel {(got - w64).abs().max().item():.3e}, plain "
                  f"{(want - w64).abs().max().item():.3e}")
            if not (math.isfinite(d) and d <= 1e-3 * top):
                raise AssertionError(f"ssd_scan_bwd {case} d{name} "
                                     f"disagrees")
            err["bwd"] = max(err["bwd"], d)
        del refs, yp, hfp, gp, y64, hf64, g64

    # timing at the main path's call: h0 None, h_final unused (dh_final
    # None), states saved for the backward
    x = _ssd_inputs(torch, gen, False)
    u, a, Bm, Cm, dy = (x[k] for k in ("u", "a", "Bm", "Cm", "dy"))
    _, _, hs = K.ssd_scan_fwd(u, a, Bm, Cm, chunk=Q)
    fwd_ms = _cuda_ms(torch, lambda: K.ssd_scan_fwd(u, a, Bm, Cm, chunk=Q),
                      hold_cycles=HOLD_CYCLES)
    bwd_ms = _cuda_ms(torch, lambda: K.ssd_scan_bwd(dy, None, u, a, Bm, Cm,
                                                    hs, chunk=Q),
                      hold_cycles=HOLD_CYCLES)
    leaves = [t.clone().requires_grad_(True) for t in (u, a, Bm, Cm)]
    fwd_plain_ms = _host_ms(torch, lambda: K.ssd_scan_plain(
        *(t.detach() for t in leaves), chunk=Q))
    yp, _ = K.ssd_scan_plain(*leaves, chunk=Q)
    bwd_plain_ms = _host_ms(torch, lambda: torch.autograd.grad(
        yp, leaves, dy, retain_graph=True))
    elems = B * S * H * P * N
    io_fwd = 4 * (2 * B * S * H * P + B * S * H + 2 * B * S * N
                  + B * H * P * N)                 # u, a, Bm, Cm -> y, h_f
    io_bwd = 4 * (3 * B * S * H * P + 2 * B * S * H + 4 * B * S * N)
    rows = {}
    for name, ms, plain_ms, flops, nbytes in (
            ("ssd_scan", fwd_ms, fwd_plain_ms, 4 * elems, io_fwd),
            ("ssd_scan_bwd", bwd_ms, bwd_plain_ms, 11 * elems, io_bwd)):
        ops_ms = flops / FP32_FLOPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": "operations" if ops_ms >= bytes_ms
                      else "bytes",
                      "max_abs_err": err["fwd" if name == "ssd_scan"
                                         else "bwd"]}
        print(f"{name}: ms={ms:.4f} plain_ms={plain_ms:.3f} "
              f"bound_ms={bound_ms:.5f} ({flops / 1e9:.2f} GFLOP -> "
              f"{ops_ms:.5f} ms, {nbytes / 1e6:.1f} MB -> {bytes_ms:.5f} ms;"
              f" {ms / bound_ms:.1f}x bound)")
    return rows


def band_pairs(S, window, causal):
    """(query, key) pairs of an S x S attention that the mask lets
    through: kpos <= qpos if causal, |qpos - kpos| < window."""
    W = min(window or S, S)
    below = W * (W + 1) // 2 + (S - W) * W       # 0 <= qpos - kpos < W
    return below if causal else 2 * below - S


def _swa_inputs(torch, gen, B, S, KV, G, hd):
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa
    return {"q": rn(B, S, KV, G, hd), "k": rn(B, S, KV, hd),
            "v": rn(B, S, KV, hd), "do": rn(B, S, KV, G, hd)}


def _swa_plain(torch, K, x, dtype, window, causal):
    """The plain version and its autograd on x cast to dtype."""
    leaves = [x[n].to(dtype).requires_grad_(True) for n in "qkv"]
    o = K.swa_flash_plain(*leaves, window=window, causal=causal)
    return o.detach(), torch.autograd.grad(o, leaves, x["do"].to(dtype))


def _swa_fp64(torch, x, window, causal):
    """The yardstick of the fp32 runs: the masked softmax and its autograd
    in fp64, one (batch, query head) at a time (the plain version computes
    in fp32 whatever its inputs' type)."""
    B, S, KV, G, hd = x["q"].shape
    pos = torch.arange(S, device="cuda")
    d = pos[:, None] - pos[None, :]
    ok = (d < (window or S)) & (-d < (window or S))
    if causal:
        ok &= d >= 0
    o = torch.empty(x["q"].shape, dtype=torch.float64, device="cuda")
    dq, dk, dv = (torch.zeros(x[n].shape, dtype=torch.float64,
                              device="cuda") for n in "qkv")
    for b in range(B):
        for h in range(KV):
            for g in range(G):
                qh = x["q"][b, :, h, g].double().requires_grad_(True)
                kh, vh = (x[n][b, :, h].double().requires_grad_(True)
                          for n in "kv")
                s = (qh @ kh.T) * hd ** -0.5
                oh = torch.softmax(s.masked_fill(~ok, -math.inf), -1) @ vh
                gq, gk, gv = torch.autograd.grad(
                    oh, (qh, kh, vh), x["do"][b, :, h, g].double())
                o[b, :, h, g] = oh.detach()
                dq[b, :, h, g] = gq
                dk[b, :, h] += gk
                dv[b, :, h] += gv
                del s, oh
    return o, (dq, dk, dv)


def _sdpa_yardstick(torch, x, window, causal):
    """One PyTorch call for the same function, timed and never on the
    path: scaled_dot_product_attention forced to the memory-efficient
    backend, with the band as a boolean mask and K/V repeated to the H
    query heads. -> (backend or None, fwd ms, bwd ms, why)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    B, S, KV, G, hd = x["q"].shape
    pos = torch.arange(S, device="cuda")
    d = pos[:, None] - pos[None, :]
    W = window or S
    mask = (d < W) & (-d < W)
    if causal:
        mask &= d >= 0
    q = x["q"].reshape(B, S, KV * G, hd).transpose(1, 2)
    k, v = (x[n][:, :, :, None].expand(B, S, KV, G, hd)
            .reshape(B, S, KV * G, hd).transpose(1, 2) for n in "kv")
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    do = x["do"].reshape(B, S, KV * G, hd).transpose(1, 2)
    backend = SDPBackend.EFFICIENT_ATTENTION
    try:
        with sdpa_kernel([backend]):
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            fwd = _cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), reps=3, trials=3,
                hold_cycles=HOLD_CYCLES)
            bwd = _cuda_ms(torch, lambda: torch.autograd.grad(
                out, (q, k, v), do, retain_graph=True), reps=3, trials=3,
                hold_cycles=HOLD_CYCLES)
        return backend.name, fwd, bwd, None
    except (RuntimeError, torch.OutOfMemoryError) as e:
        return None, None, None, f"{type(e).__name__}: {e}"[:300]


def check_swa(torch):
    """The swa_flash forward and backward kernels against the plain flash
    attention and its autograd, at starcoder2-3b's path shape and at
    gemma3-4b's head shape (window 1024, then the full window), TF32 off.
    fp32 inputs: forward allclose(atol 2e-5, rtol 1e-4), the sweep
    tolerance of tests/test_kernels.py; backward max |diff| <= 1e-3 max
    |ref| per gradient. bf16 inputs, as on the path, against the plain
    version on the same bf16 inputs: forward allclose(atol 3e-2, rtol
    3e-2) (tests/test_kernels.py's bf16 case); backward max |diff| <= 3e-2
    max |ref|. The masked softmax in fp64 (`_swa_fp64`) is printed as the
    yardstick of the fp32 ones. Times in bf16; the bound at the bf16 tensor-core peak or the
    HBM rate, whichever is larger."""
    from repro_torch.kernels import swa_attention as K
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {"fwd": 0.0, "bwd": 0.0, "fwd_bf16": 0.0, "bwd_bf16": 0.0}
    rows = {}
    for label, B, S, KV, G, hd, window, causal, on_path in SWA_CASES:
        x = _swa_inputs(torch, gen, B, S, KV, G, hd)
        for dtype, tol in ((torch.float32, None), (torch.bfloat16, 3e-2)):
            xs = {n: t.to(dtype) for n, t in x.items()}
            o, lse = K.swa_flash_fwd(xs["q"], xs["k"], xs["v"],
                                     window=window, causal=causal)
            grads = K.swa_flash_bwd(xs["do"], xs["q"], xs["k"], xs["v"], o,
                                    lse, window=window, causal=causal)
            torch.cuda.synchronize()
            op, gp = _swa_plain(torch, K, x, dtype, window, causal)
            o64, g64 = ((None, (None,) * 3) if tol else
                        _swa_fp64(torch, x, window, causal))
            tag = f"swa_flash {label} {str(dtype)[6:]}"
            d = (o.float() - op.float()).abs().max().item()
            ok = torch.allclose(o.float(), op.float(), atol=tol or 2e-5,
                                rtol=tol or 1e-4)
            yard = ("" if tol else
                    f"; vs fp64: kernel {(o - o64).abs().max().item():.3e}"
                    f", plain {(op - o64).abs().max().item():.3e}")
            print(f"{tag} o: max|diff| {d:.3e} (max|ref| "
                  f"{op.abs().max().item():.3e}){yard}; allclose (atol "
                  f"{tol or 2e-5}, rtol {tol or 1e-4}) {ok}")
            if not ok:
                raise AssertionError(f"{tag} forward disagrees")
            key = "fwd" if tol is None else "fwd_bf16"
            err[key] = max(err[key], d)
            for name, got, want, w64 in zip("qkv", grads, gp, g64):
                d = (got.float() - want.float()).abs().max().item()
                top = want.float().abs().max().item()
                yard = ("" if tol else
                        f"; vs fp64: kernel "
                        f"{(got - w64).abs().max().item():.3e}, plain "
                        f"{(want - w64).abs().max().item():.3e}")
                print(f"{tag} d{name}: max|diff| {d:.3e} (max|ref| "
                      f"{top:.3e}, ratio {d / top:.2e}){yard}")
                if not (math.isfinite(d) and d <= (tol or 1e-3) * top):
                    raise AssertionError(f"{tag} d{name} disagrees")
                key = "bwd" if tol is None else "bwd_bf16"
                err[key] = max(err[key], d)
            del o, lse, grads, op, gp, o64, g64, xs
            torch.cuda.empty_cache()

        # times in bf16, the path's type
        xb = {n: t.bfloat16() for n, t in x.items()}
        q, k, v, do = (xb[n] for n in ("q", "k", "v", "do"))
        o, lse = K.swa_flash_fwd(q, k, v, window=window, causal=causal)
        fwd_ms = _cuda_ms(torch, lambda: K.swa_flash_fwd(
            q, k, v, window=window, causal=causal), reps=5, trials=5,
            hold_cycles=HOLD_CYCLES)
        bwd_ms = _cuda_ms(torch, lambda: K.swa_flash_bwd(
            do, q, k, v, o, lse, window=window, causal=causal), reps=5,
            trials=5, hold_cycles=HOLD_CYCLES)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fwd_plain_ms = _host_ms(torch, lambda: K.swa_flash_plain(
            *(t.detach() for t in leaves), window=window, causal=causal))
        op = K.swa_flash_plain(*leaves, window=window, causal=causal)
        bwd_plain_ms = _host_ms(torch, lambda: torch.autograd.grad(
            op, leaves, do, retain_graph=True))
        del op, leaves
        torch.cuda.empty_cache()
        backend, lib_fwd, lib_bwd, why = _sdpa_yardstick(torch, xb, window,
                                                         causal)
        torch.cuda.empty_cache()
        print(f"swa_flash {label} library: "
              + (f"SDPA backend {backend}: fwd {lib_fwd:.4f} ms, bwd "
                 f"{lib_bwd:.4f} ms" if backend else
                 f"SDPA refused ({why}): none"))
        pairs = band_pairs(S, window, causal)
        heads = B * KV * G
        el = 2                                    # bf16 bytes
        n_q, n_kv = B * S * KV * G * hd, B * S * KV * hd
        io_fwd = el * (2 * n_q + 2 * n_kv) + 4 * heads * S
        io_bwd = el * (4 * n_q + 4 * n_kv) + 4 * heads * S
        for name, ms, plain_ms, lib_ms, flops, nbytes in (
                ("swa_flash", fwd_ms, fwd_plain_ms, lib_fwd,
                 4 * hd * pairs * heads, io_fwd),
                ("swa_flash_bwd", bwd_ms, bwd_plain_ms, lib_bwd,
                 10 * hd * pairs * heads, io_bwd)):
            ops_ms = flops / BF16_FLOPS * 1e3
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ms = max(ops_ms, bytes_ms)
            print(f"{name} {label}: ms={ms:.4f} plain_ms={plain_ms:.3f} "
                  f"library_ms={lib_ms} bound_ms={bound_ms:.5f} ({pairs} "
                  f"pairs x {heads} heads, {flops / 1e9:.1f} GFLOP -> "
                  f"{ops_ms:.5f} ms, {nbytes / 1e6:.1f} MB -> "
                  f"{bytes_ms:.5f} ms; {ms / bound_ms:.1f}x bound)")
            if on_path:
                rows[name] = {
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "operations" if ops_ms >= bytes_ms
                    else "bytes", "library_ms": lib_ms,
                    "library_call": (f"scaled_dot_product_attention "
                                     f"({backend})" if backend else why)}
        del x, xb, q, k, v, do, o, lse
        torch.cuda.empty_cache()
    for name in rows:
        rows[name]["max_abs_err"] = err["fwd" if name == "swa_flash"
                                        else "bwd"]
        rows[name]["max_abs_err_bf16"] = err[
            "fwd_bf16" if name == "swa_flash" else "bwd_bf16"]
    return rows


def main_path(torch, arch, seq, batch, layers, must_launch):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    ckpt = tempfile.mkdtemp(prefix="reft-chip-smoke-")
    cut = [] if layers is None else ["--layers", str(layers)]
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        rep = train.run(["--arch", arch, "--seq", str(seq), "--batch",
                         str(batch), *cut, *RUN_ARGS, "--ckpt-dir", ckpt])
        wall = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    tiers = [(r["tier"], r["bit_exact"]) for r in rep["recoveries"]]
    if tiers != [("in-memory", True), ("raim5", True)]:
        raise AssertionError(f"{arch}: recoveries {rep['recoveries']}: want "
                             f"in-memory then raim5, both byte-exact")
    if not all(e.get("device_encode") for e in rep["engine_stats"]):
        raise AssertionError(f"{arch}: device encode was off on the path")
    for name in must_launch:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the {arch} path")
    steps = rep["step_seconds"]
    if "swa_flash" in must_launch:
        # every layer, every step taken: forward and its remat recompute,
        # then one backward
        n_layers = _path_config(arch, layers).num_layers
        want = {"swa_flash": 2 * n_layers * len(steps),
                "swa_flash_bwd": n_layers * len(steps)}
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"{arch}: swa_flash launches {got}, want "
                                 f"{want}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in rep["losses"]):
        raise AssertionError(f"{arch}: loss is not finite")
    st = rep["stats"]
    flights = st.get("engine_snapshots", 0)
    launched = len(rep["snapshot_crcs"])       # SG snapshots launched
    print(f"{arch} path ({batch}x{seq}, "
          f"{'full depth' if layers is None else f'{layers} layers'}): "
          f"peak device memory {peak:.3f} GB")
    print(f"{arch} path: wall {wall:.3f} s, {len(steps)} steps, "
          f"median step {statistics.median(steps):.4f} s, losses "
          f"{rep['losses'][0]:.4f} -> {rep['losses'][-1]:.4f}, step seconds "
          + json.dumps([round(x, 4) for x in steps]))
    print(f"snapshots: {launched} SG snapshots launched, {flights} member "
          f"flights completed, avg flight "
          f"{st.get('engine_seconds', 0.0) / max(flights, 1):.4f} s, "
          f"levels l1={st.get('engine_l1_seconds', 0.0):.3f} "
          f"l2={st.get('engine_l2_seconds', 0.0):.3f} "
          f"l3={st.get('engine_l3_seconds', 0.0):.3f} s")
    print(f"{arch} launches: {json.dumps(launches)} (encode_bucket "
          f"{launches['encode_bucket'] / max(launched, 1):.1f} per SG "
          f"snapshot)")
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
    ssd = check_ssd(torch)
    swa = check_swa(torch)
    phase("4 main paths at full width")
    by_path = {arch: main_path(torch, arch, seq, batch, layers, must)
               for arch, seq, batch, layers, must in PATHS}
    phase("5 summary")
    own = rows[0]
    ssd_src = "src/repro_torch/kernels/csrc/ssd_scan.cu"
    swa_src = "src/repro_torch/kernels/csrc/swa_flash.cu"
    kernels = [{"name": "encode_bucket", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/encode_bucket.cu",
                "replaces": "src/repro/kernels/stage.py:159",
                "max_abs_err": max_err, "ms": own["ms"],
                "plain_ms": own["plain_ms"], "bound_ms": own["bound_ms"],
                "bound_by": "bytes"},
               {"name": "ssd_scan", "route": "cuda", "source": ssd_src,
                "replaces": "src/repro/kernels/ssd_scan.py:60",
                **ssd["ssd_scan"]},
               {"name": "ssd_scan_bwd", "route": "cuda", "source": ssd_src,
                "replaces": "src/repro/models/ssm.py:70 (the gradient XLA "
                            "derives from ssd_chunked; no Pallas kernel)",
                **ssd["ssd_scan_bwd"]},
               {"name": "swa_flash", "route": "cuda", "source": swa_src,
                "replaces": "src/repro/kernels/swa_attention.py:81",
                **swa["swa_flash"]},
               {"name": "swa_flash_bwd", "route": "cuda", "source": swa_src,
                "replaces": "src/repro/models/flash.py:28 (the gradient "
                            "XLA derives from flash_attention; no Pallas "
                            "kernel)",
                **swa["swa_flash_bwd"]}]
    for k in kernels:
        k["launches_by_path"] = {arch: n[k["name"]]
                                 for arch, n in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        # no single PyTorch call computes encode_bucket or the SSD scan
        k.setdefault("library_ms", None)
        k["ok"] = True
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
