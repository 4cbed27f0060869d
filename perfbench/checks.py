"""The comparison that decides `correct`.

Training (every cell): the program's first three steps against the
reference's, from the same weights and batches.
  loss_gap.first   |loss_program - loss_reference| of the first step, in
                   nats (the same weights, the same batch: a forward);
  loss_gap         the largest of the three steps';
  grad_norm_gap    the worst leaf's gap between the norm of the program's
                   first gradient as its optimizer got it (mu after step 1
                   over 1 - b1) and the norm of the reference's clipped
                   first gradient, over the larger of the reference's norm
                   of that leaf and of the median leaf;
  change_norm_gap  the same of the norm of each leaf's change over the
                   three steps, over the leaves whose reference gradient is
                   at least a thousandth of the median leaf's (the others
                   move under Adam by round-off alone);
  grad_gap, change_gap  the worst leaf's distance between the values
                   themselves, ||g_program - g_reference|| and
                   ||p_program - p_reference|| after the three steps, over
                   the same scales; `.median` the median leaf's.
A cell's `limits` name the numbers it compares; the others are printed
for the record.
The snapshot pipeline (cells that save): `snapshot_bytes`, the bytes of
the newest snapshot, as restored after the window, that differ from the
state it was taken of (a step restored other than the one taken counts
every byte). Node loss: `restore_bytes`, the same over every restore in
the window against the state held at the step restored (a step whose
state was not held counts every byte), and `resume_loss_gap`, the largest
gap, over the window's restores, between the loss of the first step run
from the restored state and the loss of the same step run from the state
held before the failure (no restore in the window reads infinite).
"""
from __future__ import annotations

import math


def median(values) -> float:
    v = sorted(values)
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def leaf_dist(a, b) -> float:
    """||a - b|| in float64, on b's device."""
    import torch
    return float(torch.linalg.vector_norm(
        a.to(b.device).double() - b.double()))


def _norm_gaps(prog: dict, ref: dict, keys) -> list:
    """Each leaf's |prog norm - ref norm| over the larger of its ref norm
    and the median leaf's."""
    floor = median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30) for k in keys]


def _value_gaps(prog: dict, ref: dict, scale: dict, keys) -> list:
    """Each leaf's ||prog - ref|| over the larger of its `scale` and the
    median leaf's."""
    floor = median(scale[k] for k in keys)
    return [leaf_dist(prog[k], ref[k]) / max(scale[k], floor, 1e-30)
            for k in keys]


def training(prog: dict, ref: dict) -> dict:
    """prog, ref: {"losses", "grads", "params" ({path: tensor}),
    "change_norms" ({path: float})} -> the numbers."""
    import torch

    def norms(tree):
        return {k: float(torch.linalg.vector_norm(v.double()))
                for k, v in tree.items()}
    g = norms(ref["grads"])
    floor = median(g.values())
    moved = [k for k, v in g.items() if v >= 1e-3 * floor]
    grad = _value_gaps(prog["grads"], ref["grads"], g, list(g))
    change = _value_gaps(prog["params"], ref["params"], ref["change_norms"],
                         moved)
    return {
        "loss_gap.first": abs(prog["losses"][0] - ref["losses"][0]),
        "loss_gap": max(abs(a - b) for a, b in
                        zip(prog["losses"], ref["losses"], strict=True)),
        "grad_norm_gap": max(_norm_gaps(norms(prog["grads"]), g, list(g))),
        "change_norm_gap": max(_norm_gaps(prog["change_norms"],
                                          ref["change_norms"], moved)),
        "grad_gap": max(grad),
        "grad_gap.median": median(grad),
        "change_gap": max(change),
        "change_gap.median": median(change),
    }


def verdict(numbers: dict, limits: dict):
    """-> (correct, {name: [value, limit]} of the numbers the cell's
    limits name; every one of them must be there). A number that is not
    finite fails."""
    rows, ok = {}, True
    for name, limit in limits.items():
        value = numbers[name]
        ok = ok and math.isfinite(value) and value <= limit
        rows[name] = [value, limit]
    return ok, rows
