"""Where the bucket encode kernel spends its time, on the card.

Times (`chip_smoke._cuda_ms`, CUDA events, the stream held by a GPU sleep)
`encode_bucket` at three of chip_smoke's ENCODE_CASES (the own 4 MiB
bucket, the 4 MiB parity bucket without CRC, the single-digest bucket)
and `encode_ranges` at two fused buckets of `chip_smoke.fused_setup` (the
own bucket 2 bytes into its leaf, the kind-2 parity bucket), for the
library built from `csrc/encode_bucket.cu` and for variants of that
source, each with one textual change (wrong results; time only):

  fold only      every block returns after the fold (no CRC at all)
  no lookups     the segment chains XOR their words instead of running
                 the slice-by-4 table lookups
  no combines    the combine trees' operator products are identities

    python3 tools/encode_bucket_profile.py      (an H100 and nvcc)
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
# (name, text in the source, its replacement); text occurring once
VARIANTS = [
    ("fold only", "  __syncthreads();\n\n  // 2. raw CRC",
     "  if (c == 0 && tid == 0) a.crc[t] = 0u;\n  return;\n\n  // 2. raw CRC"),
    ("no lookups",
     "r = crc_word(tab, r ^ sdata[w + (w >> lsw)]);",
     "r ^= sdata[w + (w >> lsw)];"),
    ("no combines", "  uint32_t s = 0;\n#pragma unroll\n  for (int k = 0; k < 8",
     "  return v;\n  uint32_t s = 0;\n#pragma unroll\n  for (int k = 0; k < 8"),
]
CASES = ("own bucket 4 MiB", "parity bucket 4 MiB", "single-digest bucket")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.smi_line())
    stage = importlib.import_module("repro_torch.kernels.stage")
    calls = []
    for i, (label, k, nbytes, want_crc) in enumerate(
            chip_smoke.ENCODE_CASES):
        if label in CASES:
            n = -(-nbytes // stage.LANE_BYTES) * (stage.LANE_BYTES // 4)
            gen = torch.Generator(device="cuda").manual_seed(i)
            raw = torch.randint(0, 256, (k, 4 * n), generator=gen,
                                dtype=torch.uint8, device="cuda")
            raw[:, nbytes:] = 0
            calls.append((label, lambda b=raw.view(torch.uint32), nb=nbytes,
                          wc=want_crc: stage.encode_bucket(
                              b, nbytes=nb, want_crc=wc)))
    enc, fused = chip_smoke.fused_setup(torch)
    for label, srcs, nbytes, want_crc in (fused[0], fused[2]):
        rows = [enc.ranges(a, b) for a, b in srcs]
        calls.append(("fused " + label, lambda r=rows, nb=nbytes,
                      wc=want_crc: stage.encode_ranges(
                          r, nbytes=nb, want_crc=wc)))
    from repro_torch.kernels.build import BUILD_DIR, build_all
    real = build_all()["encode_bucket"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        built = mutants.build(SRC, VARIANTS, Path(tmp))
        for name, so in [("real", real), *built.items()]:
            mutants.load(so, "encode_bucket", stage._SIGNATURES)
            times = [(label, chip_smoke._cuda_ms(
                torch, fn, hold_cycles=chip_smoke.HOLD_CYCLES))
                for label, fn in calls]
            print(f"{name}: " + ", ".join(f"{label} {ms:.5f} ms"
                                          for label, ms in times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
