"""The port's twins of `examples/quickstart.py` and
`examples/failure_recovery.py`, run as their users run them (on the CPU
here): the same recoveries, tiers and steps as the reference's examples
print, every restore bit-exact, and nothing left in the temp directory's
run folders."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _run(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    r = subprocess.run([sys.executable, "-m", *args], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    return r.stdout


@pytest.mark.parametrize("backend,tier", [("reft", "raim5"),
                                          ("sync_disk", "disk")])
def test_quickstart_recovers_bit_exact(tmp_path, backend, tier):
    out = _run(tmp_path, "repro_torch.examples.quickstart", "--device",
               "cpu", "--backend", backend)
    steps = re.findall(r"step (\d+): loss=(\S+) \(snapshot clean @ (\d+)\)",
                       out)
    assert [int(s) for s, _, c in steps] == list(range(1, 7))
    assert all(s == c for s, _, c in steps)
    assert f"recovered via {tier} at step 6; bit-exact: True" in out
    assert not [p for p in os.listdir(tmp_path)
                if p.startswith("reft-quickstart-")]


def test_quickstart_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.examples.quickstart"], env=env,
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


def test_failure_recovery_walks_the_three_tiers(tmp_path):
    """The reference's drill prints in-memory @ 5, raim5 @ 8 and
    checkpoint @ 8 (seed 1, 4 nodes); the twin prints the same."""
    out = _run(tmp_path, "repro_torch.examples.failure_recovery")
    got = re.findall(r"recovered via (\S+) @ step (\d+), bit-exact=(\S+)",
                     out)
    assert got == [("in-memory", "5", "True"), ("raim5", "8", "True"),
                   ("checkpoint", "8", "True")]
