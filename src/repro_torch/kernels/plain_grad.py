"""Gradients of a kernel's plain version, for the CPU impls of the
backward custom ops."""
from __future__ import annotations

import threading

import torch


def plain_grads(fn, inputs, cotangents):
    """torch.autograd.grad of `fn(*inputs)` (a tuple of outputs) against
    `cotangents`, each gradient contiguous. A custom op's impl runs with
    the autograd dispatch keys excluded and under its caller's dispatch
    modes (opcheck's, FakeTensor's cross-check); both are thread-local,
    so the plain forward is recomputed and differentiated in a thread of
    its own, which has neither."""
    out = {}

    def run():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        try:
            out["grads"] = torch.autograd.grad(fn(*leaves), leaves,
                                               cotangents)
        except BaseException as e:                  # re-raised below
            out["error"] = e

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    if "error" in out:
        raise out["error"]
    return tuple(g.contiguous() for g in out["grads"])
