"""Where the chunked SSD kernels spend their time, on the card.

Profiles the forward and backward wrappers at mamba2-130m's shape
(`chip_smoke._ssd_shape`, h0 None, dh_final None, as the main path calls
them) with `torch.profiler`, and prints each CUDA kernel's mean device
time per launch and the two wrappers' CUDA-event times (chip_smoke's
`_cuda_ms`), for the library built from `csrc/ssd_scan.cu` and for
variants of that source, each with one textual change:

  no loads       every staged float4 is a constant: no global loads in
                 the tile products (the results are wrong; time only)
  no products    mma_tile does no mma (wrong results; time only)
  prefetch       gemm issues the next chunk's loads into registers
                 before this chunk's products
  4 blocks an SM __launch_bounds__(THREADS, 4): at most 128 registers

    python3 tools/ssd_scan_profile.py      (an H100 and nvcc)
"""
import importlib
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]

import chip_smoke  # noqa: E402
import mutants  # noqa: E402

SRC = ROOT / "src/repro_torch/kernels/csrc/ssd_scan.cu"
_GEMM_LOOP = '''  for (int kc = k0; kc < k1; ++kc) {
    float4 ra[8], rb[8];
    fetch(ra, [&](int o, int i) { return fa(kc, o, i); });
    fetch(rb, [&](int o, int i) { return fb(kc, o, i); });
    __syncthreads();                        // the last products are done
    put(sA, ra);
    put(sB, rb);
    __syncthreads();
    mma_tile<TA, TB>(sA, sB, acc);
  }
'''
_PREFETCH_LOOP = '''  if (k0 >= k1) return;
  float4 ra[8], rb[8];
  fetch(ra, [&](int o, int i) { return fa(k0, o, i); });
  fetch(rb, [&](int o, int i) { return fb(k0, o, i); });
  for (int kc = k0; kc < k1; ++kc) {
    __syncthreads();
    put(sA, ra);
    put(sB, rb);
    __syncthreads();
    if (kc + 1 < k1) {
      fetch(ra, [&](int o, int i) { return fa(kc + 1, o, i); });
      fetch(rb, [&](int o, int i) { return fb(kc + 1, o, i); });
    }
    mma_tile<TA, TB>(sA, sB, acc);
  }
'''
# (name, text in the source, its replacement); text occurring once
VARIANTS = [
    ("no loads", "    r[it] = f(q / (TILE / 4), (q % (TILE / 4)) * 4);",
     "    r[it] = make_float4(q, it, 1.f, 2.f);"),
    ("no products", "    mma3(acc, ahi, alo, bhi, blo);\n", ""),
    ("prefetch", _GEMM_LOOP, _PREFETCH_LOOP),
]


def profile(torch, K, x, Q):
    """-> ({kernel: mean device ms per launch}, forward ms, backward ms)."""
    from torch.profiler import ProfilerActivity, profile as prof
    u, a, Bm, Cm, dy = (x[k] for k in ("u", "a", "Bm", "Cm", "dy"))
    _, _, hs = K.ssd_scan_fwd(u, a, Bm, Cm, chunk=Q)
    K.ssd_scan_bwd(dy, None, u, a, Bm, Cm, hs, chunk=Q)
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(5):
            K.ssd_scan_fwd(u, a, Bm, Cm, chunk=Q)
            K.ssd_scan_bwd(dy, None, u, a, Bm, Cm, hs, chunk=Q)
        torch.cuda.synchronize()
    per = {}
    for ev in p.key_averages():
        if "_kernel" in ev.key:
            total = getattr(ev, "device_time_total", None)
            if total is None:
                total = ev.cuda_time_total
            per[ev.key.split("(")[0]] = total / ev.count / 1e3
    fwd = chip_smoke._cuda_ms(torch, lambda: K.ssd_scan_fwd(
        u, a, Bm, Cm, chunk=Q), hold_cycles=chip_smoke.HOLD_CYCLES)
    bwd = chip_smoke._cuda_ms(torch, lambda: K.ssd_scan_bwd(
        dy, None, u, a, Bm, Cm, hs, chunk=Q),
        hold_cycles=chip_smoke.HOLD_CYCLES)
    return per, fwd, bwd


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.smi_line())
    K = importlib.import_module("repro_torch.kernels.ssd_scan")
    shape = chip_smoke._ssd_shape()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = chip_smoke._ssd_inputs(torch, gen, shape, False)
    from repro_torch.kernels.build import BUILD_DIR, build_all
    real = build_all()["ssd_scan"]
    text = SRC.read_text()
    bounds = ("__launch_bounds__(THREADS, 3)", "__launch_bounds__(THREADS, 4)")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        built = mutants.build(SRC, VARIANTS, Path(tmp))
        # every kernel bounded at 3 blocks an SM, bounded at 4 (the
        # source with all of them replaced, built as is)
        sub = Path(tmp) / "four"
        sub.mkdir()
        four = sub / "ssd_scan_four.cu"
        four.write_text(text.replace(*bounds))
        tile = "#define TILE 64 "
        built.update(mutants.build(four, [("4 blocks an SM", tile, tile)],
                                   sub))
        for name, so in [("real", real), *built.items()]:
            mutants.load(so, "ssd_scan", K._SIGNATURES)
            per, fwd, bwd = profile(torch, K, x, shape[5])
            print(f"{name}: forward {fwd:.4f} ms, backward {bwd:.4f} ms; "
                  "per launch (ms): " + ", ".join(
                      f"{k} {v:.4f}" for k, v in sorted(per.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
