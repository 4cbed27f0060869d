"""`python -m repro_torch.analyze [--strict] [--json OUT] PATH...`

The twin of `repro/analyze/cli.py`, over the port's own `lint` and
`protocol` (stdlib only, so it runs where JAX is not installed). The CI
gate: runs the AST lint rules over the given trees, the bounded
SMP protocol model check, and a static census of lock creation sites
(how many `threading` primitives still bypass the named-lock factories).
``--strict`` exits 1 on any unsuppressed lint finding, any model-checker
violation/wedge, or an incomplete state-space exploration.  ``--json``
writes the findings summary CI uploads as ``BENCH_analyze.json``; pass
``--lockgraph FILE`` to merge a pytest lockgraph dump (see
tests/conftest.py) into that summary.
"""
from __future__ import annotations

import argparse
import ast
import json
import sys
from pathlib import Path
from typing import List

from repro_torch.analyze.lint import RULES, Finding, iter_py, lint_file
from repro_torch.analyze.protocol import CheckConfig, model_check

__all__ = ["main"]


def _lock_census(paths: List[Path]) -> dict:
    """Count lock creation sites: named (via the lockgraph factories) vs
    raw `threading.Lock/RLock/Condition()` calls."""
    named = raw = 0
    raw_sites: List[str] = []
    for root in paths:
        for p in iter_py(Path(root)):
            try:
                tree = ast.parse(p.read_text(encoding="utf-8"))
            except SyntaxError:
                continue
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                name = ""
                if isinstance(fn, ast.Attribute):
                    base = fn.value
                    if isinstance(base, ast.Name) and base.id == "threading":
                        name = fn.attr
                elif isinstance(fn, ast.Name):
                    name = fn.id
                if name in ("named_lock", "named_rlock", "named_condition"):
                    named += 1
                elif (isinstance(fn, ast.Attribute)
                      and name in ("Lock", "RLock", "Condition")):
                    raw += 1
                    raw_sites.append(f"{p}:{node.lineno}")
    return {"named": named, "raw": raw, "raw_sites": raw_sites}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analyze")
    ap.add_argument("paths", nargs="+", help="files or trees to lint")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on findings / model-check violations")
    ap.add_argument("--json", help="write summary JSON here")
    ap.add_argument("--lockgraph",
                    help="merge a lockgraph dump (from the pytest plugin)")
    ap.add_argument("--no-model-check", action="store_true",
                    help="lint only (skip the SMP protocol model check)")
    ap.add_argument("--snapshots", type=int, default=2,
                    help="model-check bound: snapshot flights")
    ap.add_argument("--persists", type=int, default=2,
                    help="model-check bound: in-flight persists")
    args = ap.parse_args(argv)

    paths = [Path(p) for p in args.paths]
    suppressed: List[Finding] = []
    findings: List[Finding] = []
    for root in paths:
        for p in iter_py(root):
            findings.extend(lint_file(p, suppressed))

    for f in findings:
        print(f, file=sys.stderr)

    rule_counts = {r: 0 for r in RULES}
    for f in findings:
        rule_counts[f.rule] = rule_counts.get(f.rule, 0) + 1
    sup_counts: dict = {}
    for f in suppressed:
        sup_counts[f.rule] = sup_counts.get(f.rule, 0) + 1

    summary = {
        "findings": len(findings),
        "suppressed": len(suppressed),
        "rule_counts": rule_counts,
        "suppressed_counts": sup_counts,
        "locks": _lock_census(paths),
    }

    mc_bad = False
    if not args.no_model_check:
        res = model_check(CheckConfig(max_snapshots=args.snapshots,
                                      max_persists=args.persists))
        summary["model_check"] = {
            "states": res.states,
            "transitions": res.transitions,
            "violations": len(res.violations),
            "wedges": len(res.wedges),
            "complete": res.complete,
        }
        mc_bad = not res.ok
        print(f"model check: {res.states} states, {res.transitions} "
              f"transitions, {len(res.violations)} violations, "
              f"{len(res.wedges)} wedges, complete={res.complete}",
              file=sys.stderr)
        for v in (res.violations + res.wedges)[:5]:
            print(f"  counterexample: {v.get('kind', 'wedge')}\n"
                  f"    trace: {' '.join(v['trace'])}", file=sys.stderr)

    if args.lockgraph:
        try:
            summary["lockgraph"] = json.loads(
                Path(args.lockgraph).read_text())
        except (OSError, ValueError) as e:
            print(f"lockgraph merge failed: {e}", file=sys.stderr)

    if args.json:
        Path(args.json).write_text(json.dumps(summary, indent=2,
                                              sort_keys=True))

    print(f"analyze: {len(findings)} findings "
          f"({len(suppressed)} pragma-suppressed)", file=sys.stderr)
    if args.strict and (findings or mc_bad):
        return 1
    return 0
