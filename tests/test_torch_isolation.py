"""The PyTorch port stands alone: it never loads JAX, never imports the JAX
package, keeps the snapshot-manager processes torch-free, and refuses to
fall back to the CPU silently."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _python(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_every_module_leaves_jax_out():
    r = _python(
        "import importlib, pkgutil, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) > 40, mods\n"
        "for m in ('repro_torch.examples.serve', 'repro_torch.analyze.cli',"
        " 'repro_torch.analyze.lint', 'repro_torch.analyze.__main__'):\n"
        "    assert m in mods, m\n"
        "assert 'jax' not in sys.modules\n"
        "bad = [m for m in sys.modules if m == 'repro' or "
        "m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


@pytest.mark.parametrize("module", ["repro_torch.core.smp",
                                    "repro_torch.launch.train",
                                    "repro_torch.supervise.run",
                                    "repro_torch.store",
                                    "repro_torch.store.scrub"])
def test_spawned_smp_imports_stay_torch_free(module):
    """SMP children start with `spawn`: they import `core.smp` and re-import
    the launching `__main__` module (the trainer's or the supervised
    drill's), and their persist worker imports `repro_torch.store` to
    upload shards; all must stay numpy-only."""
    r = _python(f"import sys, {module}\n"
                "assert 'torch' not in sys.modules\n"
                "assert 'jax' not in sys.modules\n")
    assert r.returncode == 0, r.stderr


def test_no_module_imports_the_jax_package():
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("repro", "jax", "jaxlib"):
                    offenders.append(f"{path.relative_to(ROOT)}:"
                                     f"{node.lineno} {name}")
    assert not offenders, offenders


def test_train_without_device_raises_on_a_host_without_cuda(monkeypatch):
    import torch

    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--arch", "opt-125m", "--reduced", "--steps", "1"])


def test_serve_without_device_raises_on_a_host_without_cuda(monkeypatch):
    import torch

    from repro_torch.examples import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main([])


@pytest.mark.parametrize("extra", [(), ("--arch", "jamba-v0.1-52b")],
                         ids=["", "jamba"])
def test_serve_example_runs_on_the_cpu(extra, capsys):
    from repro_torch.examples import serve
    serve.main(["--device", "cpu", *extra])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served batch=4: generated 24 tokens/request")
    assert out[1].startswith("sample: [")
