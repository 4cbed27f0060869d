"""What a run imports, in a clean interpreter: the harness, the reference
and the program's modules a run drives load neither JAX nor the JAX
package (top-level names compared whole), and the reference loads nothing
of the program. Without a CUDA device a run exits non-zero and prints no
result."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _modules(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_imports_neither_jax_nor_the_program():
    got = _modules("from perfbench import reference, checks, data, "
                   "weights, formulas\nimport perfbench.reference.model")
    assert not got & FORBIDDEN
    assert "repro_torch" not in got
    assert "torch" in got


def test_a_run_imports_no_jax():
    got = _modules(
        "import sys; sys.path[:0] = ['src', '.']\n"
        "import perfbench.run as r; r.setup_environment()\n"
        "from perfbench import harness, tracing, spec, calibrate\n"
        "from repro_torch.api import CheckpointSession, CheckpointSpec\n"
        "from repro_torch.kernels import launch_counts\n"
        "from repro_torch.train.steps import make_train_step, state_to\n"
        "from repro_torch.optim.adam import adam_init\n"
        "import repro_torch.core.smp, repro_torch.core.recovery\n"
        "import repro_torch.models.model\n"
        "from repro_torch.core.coordinator import ReftGroup")
    assert "repro_torch" in got
    assert not got & FORBIDDEN, got & FORBIDDEN


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(ROOT))
    from perfbench import run
    assert run.forbidden_modules(["repro_torch", "repro_torch.api",
                                  "reprox", "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["repro.core.smp", "jax._src", "flax",
                                  "jaxlib.xla"]) == ["flax", "jax", "jaxlib",
                                                     "repro"]


def test_without_a_card_a_run_exits_non_zero_with_no_result():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "mamba2-130m.b16.nodeloss", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
