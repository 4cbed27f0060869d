"""The benchmark's bound and FLOP formulas against the shapes and figures
of the port's kernel table (PERF.md), and the model FLOPs of a step."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import formulas  # noqa: E402
from perfbench.weights import layout, numel  # noqa: E402


def _config(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("shape, fwd_ms, bwd_ms", [
    ((2, 2048, 24, 64, 128, 256), 0.02062, 0.03545),     # mamba2-130m
    ((1, 4096, 128, 64, 16, 256), 0.08357, 0.12442),     # Jamba train
])
def test_ssd_bounds_match_the_kernel_table(shape, fwd_ms, bwd_ms):
    f, b = formulas.ssd_bound_s(*shape)
    assert f * 1e3 == pytest.approx(fwd_ms, abs=5e-6)
    assert b * 1e3 == pytest.approx(bwd_ms, abs=5e-6)


def test_encode_flight_bytes_a_bucket():
    """A 4 MiB own bucket moves 8 MiB (0.00250 ms at 3.35 TB/s); a parity
    bucket of an SG of 4 folds 3 rows into one, 16 MiB (0.00501 ms)."""
    bucket = 4 << 20
    moved, launches = formulas.encode_flight(12 * bucket, 4, bucket)
    assert launches == 16
    assert moved == 4 * (3 * 2 * bucket + 4 * bucket)
    assert 2 * bucket / 3.35e12 * 1e3 == pytest.approx(0.00250, abs=5e-6)
    assert 4 * bucket / 3.35e12 * 1e3 == pytest.approx(0.00501, abs=5e-6)
    tail, launches = formulas.encode_flight(12 * bucket + 12, 4, bucket)
    assert launches == 32                      # a second, one-lane bucket
    assert tail - moved == 4 * 10 * formulas.LANE_BYTES


@pytest.mark.parametrize("name, rows, seq", [("mamba2-130m", 16, 2048)])
def test_model_flops_against_the_parameter_count(name, rows, seq):
    """6 x (all parameters but the embedding, norms and the SSM's small
    vectors) x tokens, plus the mixer's own products."""
    c = _config(name)
    mats = sum(numel(x.shape) for x in layout(c) if len(x.shape) == 3
               and x.path[-1] != "conv_w")
    head = c["d_model"] * c["vocab_size"]
    base = 6.0 * (mats + head) * rows * seq
    got = formulas.model_flops(c, rows, seq)
    assert got > base
    f, _ = formulas.ssd_flops(rows, seq, 24, 64, 128, 256)
    assert got == pytest.approx(base + 24 * 3 * f)
    assert got == pytest.approx(28.17e12, rel=1e-3)


def test_state_bytes_of_the_configurations():
    c = _config("mamba2-130m")
    assert formulas.state_bytes(c) == 1_289_838_352
    assert c["state_bytes"] == formulas.state_bytes(c)
    assert c["params"] == sum(numel(x.shape) for x in layout(c))
