"""The slices end to end on the CPU: `python -m repro_torch.launch.train`
recovers through the in-memory tier, then through a RAIM5 decode, with
every restored state byte-exact, and finishes with a finite loss — for
opt-125m once with the host encode path and once with the device encode
path forced on (the kernel's plain version, since the state lives on the
CPU), and for mamba2-130m over a sequence of two SSD chunks."""
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _train(tmp_path, arch, seq, device_encode, batch=2):
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--device", "cpu", "--arch", arch, "--reduced",
           "--steps", "12", "--batch", str(batch), "--seq", str(seq),
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
    return out


@pytest.mark.parametrize("device_encode", ["auto", "on"])
def test_train_recovers_through_both_tiers(device_encode, tmp_path):
    _train(tmp_path, "opt-125m", 64, device_encode)


def test_mamba2_train_recovers_through_both_tiers(tmp_path):
    """Reduced mamba2-130m keeps the SSD chunk of 256: 320 tokens make two
    chunks of 160, so the state carried over a chunk boundary is trained
    through, and its fp32 leaves ride in every snapshot and restore."""
    out = _train(tmp_path, "mamba2-130m", 320, "on")
    assert "arch=mamba2-130m-smoke" in out, out


def test_starcoder2_train_recovers_through_both_tiers(tmp_path):
    """Reduced starcoder2-3b (window 64) at seq 2048, the flash threshold:
    every layer's attention runs `swa_flash` (its plain version here)."""
    out = _train(tmp_path, "starcoder2-3b", 2048, "on", batch=1)
    assert "arch=starcoder2-3b-smoke layers=2" in out, out
    assert "batch=1x2048" in out, out
