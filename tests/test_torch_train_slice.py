"""The slices end to end on the CPU: `python -m repro_torch.launch.train`
recovers through the in-memory tier, then through a RAIM5 decode, with
every restored state byte-exact, and finishes with a finite loss — for
opt-125m once with the host encode path and once with the device encode
path forced on (the kernel's plain version, since the state lives on the
CPU), and for mamba2-130m over a sequence of two SSD chunks.

The durable tiers: opt-125m under `objstore` (the same two recoveries,
with shards uploaded to the object store), and under `sync_disk` and
`async_disk` (a software failure restored from disk, byte-exact). Below
RAM, a fresh `objstore` checkpointer of each package (no snapshot in its
SMPs) restores a small numpy state from the `.reft` family of either
package (tier `checkpoint`), then, with every `.reft` file deleted, from
the object store (tier `objstore`), all byte-identical."""
import glob
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.api import CheckpointSpec as JaxSpec
from repro.api.registry import create_checkpointer as jax_create
from repro.core.treebytes import leaf_arrays as jax_leaf_arrays
from repro_torch import convert
from repro_torch.api import CheckpointSpec
from repro_torch.api.registry import create_checkpointer
from repro_torch.core.treebytes import host_bytes, leaf_arrays

ROOT = Path(__file__).resolve().parents[1]
BOTH = [("in-memory", "True"), ("raim5", "True")]


def _train(tmp_path, arch, seq, device_encode, batch=2, backend="reft",
           inject=("6:software", "10:node"), want=BOTH, extra=()):
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--device", "cpu", "--arch", arch, "--reduced",
           "--steps", "12", "--batch", str(batch), "--seq", str(seq),
           "--backend", backend, "--snapshot-every", "2",
           *(a for i in inject for a in ("--inject", i)),
           "--ckpt-dir", str(tmp_path), *extra,
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
    assert tiers == want, out
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


@pytest.mark.parametrize("backend", ["objstore", "sync_disk", "async_disk"])
def test_train_durable_backends_recover(backend, tmp_path):
    if backend == "objstore":
        out = _train(tmp_path, "opt-125m", 64, "auto", backend=backend,
                     extra=("--ckpt-every", "4"))
        up = re.search(r"\[objstore\] uploads=(\S+)MB", out)
        assert up and float(up.group(1)) > 0, out
        assert glob.glob(str(tmp_path / "objstore" / "families" / "step-*"
                             / "MANIFEST.json")), out
    else:
        out = _train(tmp_path, "opt-125m", 64, "auto", backend=backend,
                     inject=("6:software",), want=[("disk", "True")])
        assert glob.glob(str(tmp_path / "ckpt-*-r0.bin")), out


def _numpy_state(seed=0):
    rng = np.random.default_rng(seed)
    import ml_dtypes
    return {"params": {"w": rng.standard_normal((53, 37)).astype(np.float32),
                       "e": rng.standard_normal(3001)
                       .astype(ml_dtypes.bfloat16)},
            "opt_state": {"mu": {"w": rng.standard_normal((53, 37))
                                 .astype(np.float32)}},
            "rng": np.asarray([0, 12345], np.uint32),
            "step": np.asarray(7, np.int32)}


def _flat(tree, leaves):
    """The flat stream of a tree of tensors or of JAX arrays."""
    return np.concatenate([host_bytes(x) for x in leaves(tree)])


def test_ladder_below_ram_matches_reference(tmp_path):
    tree = _numpy_state()
    pkgs = {"jax": (jax_create, JaxSpec, jax_leaf_arrays,
                    jax.tree_util.tree_map(jnp.asarray, tree)),
            "torch": (create_checkpointer, CheckpointSpec, leaf_arrays,
                      convert.state_from_numpy(tree, "cpu"))}
    want = _flat(pkgs["torch"][3], leaf_arrays)
    for name, (create, spec_cls, _, state) in pkgs.items():
        spec = spec_cls(backend="objstore", ckpt_dir=str(tmp_path / name),
                        sg_size=2, options={"scrub_every_s": 0.0})
        with create(spec, state) as ck:
            assert ck.snapshot(state, 7, extra_meta={"ds": 4}, wait=True)
            assert ck.persist(wait=True) == 7
    readers = {}
    try:
        for name, (create, spec_cls, leaves, state) in pkgs.items():
            for wrote in pkgs:
                spec = spec_cls(backend="objstore", sg_size=2,
                                ckpt_dir=str(tmp_path / wrote),
                                options={"scrub_every_s": 0.0})
                readers[name, wrote] = ck = create(spec, state)
                res = ck.restore()
                assert (res.tier, res.step, res.extra_meta) == \
                    ("checkpoint", 7, {"ds": 4}), (name, wrote)
                assert np.array_equal(_flat(res.state, leaves), want)
        for wrote in pkgs:
            for p in glob.glob(str(tmp_path / wrote / "*.reft")):
                os.unlink(p)
        for (name, wrote), ck in readers.items():
            res = ck.restore()
            assert (res.tier, res.step) == ("objstore", 7), (name, wrote)
            assert np.array_equal(_flat(res.state, pkgs[name][2]), want)
    finally:
        for ck in readers.values():
            ck.close()
