"""Planted faults in the bf16 swa_flash kernels, against phase 3's checks.

Each mutant is a copy of `src/repro_torch/kernels/csrc/swa_flash_bf16.cu`
with one textual change, built by nvcc into a temporary directory and
loaded in place of the real library. For the real library and each
mutant, at starcoder2-3b's shape and at chip_smoke.py's SWA_EDGE_CASES,
the script holds the bf16 outputs as phase 3 of chip_smoke.py does, and
prints whether each of its two checks catches the fault: the tolerances
phase 3 had first (forward allclose(atol 3e-2, rtol 3e-2), each gradient
max |diff| <= 3e-2 max |ref|; at starcoder2-3b's shape, against the plain
version) and the row check (`chip_smoke._rows_held` against
`chip_smoke._swa_fp64_given_o`, every case). It exits 0 when the real
library passes both checks everywhere and the row check catches every
mutant. The last three are faults of the padded route (hd 80, 96, 112 on
the hd-128 kernels), caught at SWA_EDGE_CASES' padded rows; the last,
whose stores run past the output, comes last because a fault it raises
on the card ends every later launch in the process.

    python3 tools/swa_flash_mutants.py      (an H100 and nvcc)
"""
import importlib
import math
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]

import chip_smoke  # noqa: E402
import mutants  # noqa: E402

SRC = ROOT / "src/repro_torch/kernels/csrc/swa_flash_bf16.cu"
# (name, text in the source, its replacement)
MUTANTS = [
    ("window edge off by one (a key at distance `window` is seen)",
     "(qpos - kpos < window) &&", "(qpos - kpos <= window) &&"),
    ("forward drops the middle key tile of bands of 3 or more",
     "      sacc[e] = x;\n",
     "      sacc[e] = (ntiles > 2 && i == ntiles / 2) ? NEG_INF : x;\n"),
    ("dK/dV drops the middle query tile of each band",
     "const float p = exp2f(x - L[col]);",
     "const float p = it % ntiles == ntiles / 2 ? 0.f"
     " : exp2f(x - L[col]);"),
    ("D pre-pass leaves out the last column of dO o O",
     "        acc = fmaf(fa.y, fc.y, acc);\n",
     "        if (!(part == TPR - 1 && v == 1 && j == 3))\n"
     "          acc = fmaf(fa.y, fc.y, acc);\n"),
    ("dV zeroed for keys 1024 and past",
     "pack_bf16(dV[4 * i + 2 * half], dV[4 * i + 2 * half + 1])",
     "pack_bf16(kpos < 1024 ? dV[4 * i + 2 * half] : 0.f,"
     " kpos < 1024 ? dV[4 * i + 2 * half + 1] : 0.f)"),
    ("padded widths: the forward's scale from the padded width, not hd",
     "(bf16*)o, lse, Sq, Sk, KV, G, window, causal, scale);",
     "(bf16*)o, lse, Sq, Sk, KV, G, window, causal,"
     " HS == HD ? scale : 1.f / sqrtf((float)HD));"),
    ("padded widths: out-of-bounds boxes filled with NaN, not zero",
     "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE",
     "CU_TENSOR_MAP_FLOAT_OOB_FILL_NAN_REQUEST_ZERO_FMA"),
    ("padded widths: dQ stored with the padded row stride",
     "dq + (((long long)b * Sq + qpos) * H + h) * HS",
     "dq + (((long long)b * Sq + qpos) * H + h) * HD"),
]


def verdicts(torch, K, x, plain, window, causal):
    """-> (earlier tolerances hold or None, row check holds, worst ratio)
    for the bf16 kernels on x: the earlier tolerances against the plain
    version's (o, grads) `plain` where given, the row check against
    `chip_smoke._swa_fp64_given_o`."""
    xs = {n: t.bfloat16() for n, t in x.items()}
    try:
        o, lse = K.swa_flash_fwd(xs["q"], xs["k"], xs["v"], window=window,
                                 causal=causal)
        grads = K.swa_flash_bwd(xs["do"], xs["q"], xs["k"], xs["v"], o, lse,
                                window=window, causal=causal)
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"    raised: {e}"[:200])
        return False, False, math.inf
    o64, g64 = chip_smoke._swa_fp64_given_o(torch, xs, o, window, causal)
    earlier = None if plain is None else True
    rows, worst = True, 0.0
    for i, (got, ref) in enumerate(zip((o, *grads), (o64, *g64))):
        if plain is not None:
            g, w = got.float(), (plain[0], *plain[1])[i].float()
            if i == 0:
                earlier &= torch.allclose(g, w, atol=3e-2, rtol=3e-2)
            else:
                d = (g - w).abs().max().item()
                earlier &= math.isfinite(d) and \
                    d <= 3e-2 * w.abs().max().item()
        tensor, row, _ = chip_smoke._rows_held(torch, got, ref,
                                               torch.bfloat16)
        rows &= tensor <= 1 and row <= 1
        worst = max(worst, tensor, row)
    return earlier, rows, worst


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    K = importlib.import_module("repro_torch.kernels.swa_attention")
    label, B_, S, KV, G, hd, window, causal, _ = chip_smoke.SWA_CASES[0]
    cases = [(label, B_, S, KV, G, hd, window, causal),
             *chip_smoke.SWA_EDGE_CASES]
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = []
    for c in cases:
        x = chip_smoke._swa_inputs(torch, gen, *c[1:6])
        inputs.append((c, x, chip_smoke._swa_plain(
            torch, K, x, torch.bfloat16, c[6], c[7]) if c is cases[0]
            else None))
    from repro_torch.kernels.build import BUILD_DIR, build_all
    real = build_all()["swa_flash_bf16"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        ok = True
        for name, so in [("(real library)", real),
                         *mutants.build(SRC, MUTANTS, Path(tmp)).items()]:
            mutants.load(so, "swa_flash_bf16", K._BF16_SIGNATURES)
            caught_earlier = caught_rows = False
            print(f"{name}:")
            for c, x, plain in inputs:
                try:
                    earlier, rows, worst = verdicts(torch, K, x, plain,
                                                    c[6], c[7])
                except RuntimeError as e:      # a fault on the card
                    print(f"    {c[0]}: raised: {e}"[:200])
                    caught_rows = True
                    break
                print(f"    {c[0]}: "
                      + ("" if earlier is None else
                         f"earlier tolerances {'hold' if earlier else 'fail'}"
                         ", ")
                      + f"row check {'holds' if rows else 'fails'} (worst "
                      f"ratio {worst:.3g} of its bound)")
                caught_earlier |= earlier is False
                caught_rows |= not rows
            if so == real:
                ok &= not caught_rows and not caught_earlier
            else:
                ok &= caught_rows
                print(f"  caught by the earlier tolerances: {caught_earlier};"
                      f" by the row check: {caught_rows}")
        print(f"MUTANTS {'OK' if ok else 'BAD'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
