"""The slice end to end on the CPU: `python -m repro_torch.launch.train`
recovers through the in-memory tier, then through a RAIM5 decode, with
every restored state byte-exact, and finishes with a finite loss — once
with the host encode path and once with the device encode path forced on
(the kernel's plain version, since the state lives on the CPU)."""
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("device_encode", ["auto", "on"])
def test_train_recovers_through_both_tiers(device_encode, tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--device", "cpu", "--arch", "opt-125m", "--reduced",
           "--steps", "12", "--batch", "2", "--seq", "64",
           "--snapshot-every", "2", "--inject", "6:software",
           "--inject", "10:node", "--ckpt-dir", str(tmp_path),
           "--device-encode", device_encode, "--verify-restores"]
    # one OpenMP thread: the reduced model is tiny, and the suite runs
    # this beside other workers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    out = r.stdout
    tiers = re.findall(r"\[recover\] tier=(\S+) step=\d+ bit_exact=(\S+)",
                       out)
    assert tiers == [("in-memory", "True"), ("raim5", "True")], out
    stats = re.search(r"device_encode=(\S+)", out)
    assert stats and stats.group(1) == str(device_encode == "on"), out
    done = re.search(r"\[done\] steps=12 final_loss=(\S+)", out)
    assert done and math.isfinite(float(done.group(1))), out
