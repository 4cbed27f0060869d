"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` compiles with `nvcc` for sm_90a into its own shared
library with a plain C interface under `<repo>/build/kernels/`, named by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads from the cache.  All sources compile in parallel (one
`nvcc` each, started together).  `ptxas -v`'s report (registers, spills,
shared memory of each kernel) is kept beside each library as `.log`.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()          # first use may come from several threads


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for extra in sorted(CSRC.glob("*.cuh")):
        h.update(extra.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale `csrc/*.cu` (in parallel); name -> .so path."""
    sources = sorted(CSRC.glob("*.cu"))
    targets = {s.stem: _target(s) for s in sources}
    stale = [s for s in sources if not targets[s.stem].exists()]
    if stale:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for s in stale:
            tmp = targets[s.stem].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)]
            procs.append((s, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for s, tmp, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{s.name}:\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                targets[s.stem].with_suffix(".log").write_text(log)
                os.replace(tmp, targets[s.stem])   # atomic vs concurrent builds
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return targets


def resource_report(name: str) -> list:
    """ptxas's lines on each kernel of `csrc/<name>.cu` (entry function,
    registers, spill stores and loads), from its build log; [] when the
    library was built before logs were kept."""
    log = _target(CSRC / f"{name}.cu").with_suffix(".log")
    if not log.exists():
        return []
    keep = ("Compiling entry function", "spill stores", "Used ")
    return [ln.strip() for ln in log.read_text().splitlines()
            if any(k in ln for k in keep)]


def library(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu`, with each entry of
    `signatures` ({function: (argtypes, restype)}) declared."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build_all()[name]))
                for fn, (argtypes, restype) in signatures.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
                _LIBS[name] = lib
    return lib
