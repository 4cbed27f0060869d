"""Planted faults in the chunked SSD kernels, against phase 3's check.

Each mutant is a copy of `src/repro_torch/kernels/csrc/ssd_scan.cu` with
one textual change, built by nvcc into a temporary directory and loaded in
place of the real library. For the real library and each mutant, at
mamba2-130m's shape (h0 random) and at chip_smoke.py's SSD_EDGE_CASES, the
script runs phase 3's check (`chip_smoke._ssd_held`: y and h_final
allclose(atol 5e-4, rtol 1e-3), each gradient max |diff| <= 1e-3 max
|ref|, against the fp32 and the fp64 plain scan, da finite) and prints the
worst ratio of any check to its bound (above 1 fails). It exits 0 when the
real library holds everywhere and the check fails every mutant.

    python3 tools/ssd_scan_mutants.py      (an H100 and nvcc)
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
# (name, text in the source, its replacement)
MUTANTS = [
    ("the mask applied after the exponential",
     "return keep ? expf(ct - cs) : 0.f;",
     "return expf(ct - cs) * (float)keep;"),
    ("state passing skips the decay of chunk 1",
     "    const float ea = expf(A);\n",
     "    const float ea = i == 1 ? 1.f : expf(A);\n"),
    ("the chunk scan drops the last row of each t-tile",
     "        if (t < d.Q) {\n          v = ld4(Sm + d.qq(bc, t, s), d.Q - s);",
     "        if (o < TILE - 1 && t < d.Q) {\n"
     "          v = ld4(Sm + d.qq(bc, t, s), d.Q - s);"),
    ("the split's cross terms dropped (one bf16 product)",
     "  for (int j = 0; j < 8; ++j) mma_bf16(acc[j], alo, bhi + 2 * j);\n"
     "#pragma unroll\n"
     "  for (int j = 0; j < 8; ++j) mma_bf16(acc[j], ahi, blo + 2 * j);\n",
     ""),
    ("dB without its state term",
     "const int heads = d.H * npt;",
     "const int heads = is_db ? 0 : d.H * npt;"),
    ("da without the chunk-end term",
     "    dcum[d.Q - 1] += expf(A) * tot + zt;\n",
     ""),
]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    K = importlib.import_module("repro_torch.kernels.ssd_scan")
    main_shape = chip_smoke._ssd_shape()
    cases = [("main h0 random", *main_shape), *chip_smoke.SSD_EDGE_CASES]
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = [(c[0], chip_smoke._ssd_inputs(torch, gen, c[1:], True),
               K.chunk_len(c[2], c[6])) for c in cases]
    from repro_torch.kernels.build import BUILD_DIR, build_all
    real = build_all()["ssd_scan"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        ok = True
        for name, so in [("(real library)", real),
                         *mutants.build(SRC, MUTANTS, Path(tmp)).items()]:
            mutants.load(so, "ssd_scan", K._SIGNATURES)
            print(f"{name}:")
            caught = False
            for label, x, Q in inputs:
                try:
                    _, worst = chip_smoke._ssd_held(torch, K, label, x, Q,
                                                    strict=False)
                except RuntimeError as e:
                    print(f"    {label}: raised: {e}"[:200])
                    worst = float("inf")
                print(f"    {label}: check {'holds' if worst <= 1 else 'fails'}"
                      f" (worst ratio {worst:.3g} of its bound)")
                caught |= not worst <= 1
            ok &= caught if so != real else not caught
            if so != real:
                print(f"  caught: {caught}")
        print(f"MUTANTS {'OK' if ok else 'BAD'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
