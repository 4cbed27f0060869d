"""Find what `BENCHMARK.json` names, by name: a cell in
`workloads/<name>.json`, the configuration and the traffic it names in
`configs/<name>.json` and `traffic/<name>.json`, and each metric's
reader in `metrics/<name>.py`. Adding any of them is adding a file."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _named(kind: str, name: str, suffix: str, base: Path) -> Path:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    path = base / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    return path


def _json(kind: str, name: str, base: Path) -> dict:
    return json.loads(_named(kind, name, ".json", base).read_text())


def benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(name: str, base: Path = HERE) -> dict:
    return _json("workloads", name, base)


def config(name: str, base: Path = HERE) -> dict:
    return _json("configs", name, base)


def traffic(name: str, base: Path = HERE) -> dict:
    return _json("traffic", name, base)


def reader(name: str, base: Path = HERE):
    """The `read(record)` function of metric `name`."""
    path = _named("metrics", name, ".py", base)
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list:
    """[(name, unit)] that a run of `cell_name` reports: its end-to-end
    metrics untraced, its per-layer metrics traced. A metric with a
    `workloads` list belongs to those cells; one without belongs to every
    cell that reports the end-to-end metric it moves (an end-to-end
    metric without one, to every cell)."""
    def mine(m):
        return cell_name in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if mine(m) is not False]
    if not trace:
        return [(m["name"], m["unit"]) for m in e2e]
    moved = {m["name"] for m in e2e}
    return [(m["name"], m["unit"]) for m in bench["per_layer"]
            if mine(m) or (mine(m) is None and m["moves"] in moved)]
