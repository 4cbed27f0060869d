"""Shared by the planted-fault scripts: build mutants of a CUDA source and
route a kernel module's wrappers to one of them.

A mutant is the source with one textual change (`(name, old, new)`, `old`
occurring exactly once), built by nvcc with the port's flags.
"""
import ctypes
import subprocess
from pathlib import Path


def build(src: Path, mutants, out_dir: Path):
    """nvcc every mutant of `src` in parallel. -> {name: .so path}."""
    from repro_torch.kernels import build as B
    text = src.read_text()
    procs = {}
    for i, (name, old, new) in enumerate(mutants):
        if text.count(old) != 1:
            raise AssertionError(f"mutant {name!r}: {old!r} occurs "
                                 f"{text.count(old)} times in {src.name}")
        cu = out_dir / f"mutant{i}.cu"
        cu.write_text(text.replace(old, new))
        so = out_dir / f"libmutant{i}.so"
        procs[name] = (so, subprocess.Popen(
            [B._nvcc(), *B.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"mutant {name!r} failed to build:\n{log}")
    return {name: so for name, (so, _) in procs.items()}


def load(so, name: str, signatures: dict):
    """Load the library at `so` as the port's library `name` (the one
    `kernels.build.library(name, ...)` returns), with `signatures`."""
    from repro_torch.kernels import build as B
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    B._LIBS[name] = lib
