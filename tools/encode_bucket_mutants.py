"""Planted faults in the bucket encode kernel, against phase 3's check.

Each mutant is a copy of `src/repro_torch/kernels/csrc/encode_bucket.cu`
with one textual change, built by nvcc into a temporary directory and
loaded in place of the real library. For the real library and each
mutant the script runs phase 3's encode check
(`chip_smoke.check_encode_bucket`, untimed): `encode_bucket` at
ENCODE_CASES and `encode_ranges` at the fused buckets cut from opt-125m's
FlatSpec (`chip_smoke.fused_setup`), each bit-exact against its plain
version, digests folded by `bucket_crc` equal to `zlib.crc32`. It prints
the cases each one fails and exits 0 when the real library holds
everywhere and the check fails every mutant.

    python3 tools/encode_bucket_mutants.py      (an H100 and nvcc)
"""
import importlib
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]

import chip_smoke  # noqa: E402
import mutants  # noqa: E402

SRC = ROOT / "src/repro_torch/kernels/csrc/encode_bucket.cu"
# (name, text in the source, its replacement)
MUTANTS = [
    ("zlib's initial 0xFFFFFFFF not folded in",
     "uint32_t r = (c == 0 && lo == 0 && hi > 0) ? 0xFFFFFFFFu : 0u;",
     "uint32_t r = 0u;"),
    ("the in-warp tree's operators one level long",
     "r = zapply(ops + 128 * l, r) ^ next;",
     "r = zapply(ops + 128 * (l + 1), r) ^ next;"),
    ("the blocks combined in reverse order",
     "const int m = e - 1 - lane;",
     "const int m = lane;"),
    ("segments left-aligned instead of right-aligned",
     "const int hi = live - (ENC_THREADS - 1 - tid) * sw;",
     "const int hi = min(live, (tid + 1) * sw);"),
    ("a straddling window's later slices shifted by one byte",
     "(unsigned long long)sl[s].src + (unsigned long long)(p - d);",
     "(unsigned long long)sl[s].src + (unsigned long long)(p - d)"
     " + (s > l);"),
    ("the tail bytes dropped",
     "for (int j = 0; j < rem; ++j) {",
     "for (int j = 0; j < 0; ++j) {"),
    ("bytes past a slice's end not masked off (next slice, pad)",
     "byte_mask(blo - 4 * m, bhi - 4 * m);",
     "byte_mask(blo - 4 * m, 4);"),
]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    stage = importlib.import_module("repro_torch.kernels.stage")
    fused = chip_smoke.fused_setup(torch)
    from repro_torch.kernels.build import BUILD_DIR, build_all
    real = build_all()["encode_bucket"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        ok = True
        for name, so in [("(real library)", real),
                         *mutants.build(SRC, MUTANTS, Path(tmp)).items()]:
            mutants.load(so, "encode_bucket", stage._SIGNATURES)
            try:
                rows, frows, _ = chip_smoke.check_encode_bucket(
                    torch, fused, strict=False, timed=False)
                failed = [r["failure"] for r in rows + frows if not r["ok"]]
            except RuntimeError as e:
                failed = [f"raised: {e}"[:200]]
            caught = bool(failed)
            n_cases = len(chip_smoke.ENCODE_CASES) + 1 + len(fused[1])
            print(f"{name}: {len(failed)} of {n_cases} cases (the wide "
                  f"tile's refusal one of them) fail phase 3's check")
            for f in failed:
                print(f"    {f}"[:200])
            ok &= caught if so != real else not caught
            if so != real:
                print(f"  caught: {caught}")
        print(f"MUTANTS {'OK' if ok else 'BAD'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
