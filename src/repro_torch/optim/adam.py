"""AdamW, out of place.

The counterpart of `repro/optim/adam.py`.  Every call returns NEW tensors
for the parameters and both moments (no `add_`/`copy_` on a state leaf,
no `torch.optim`): a snapshot in flight holds the previous step's leaves,
and they must not change under it.  Moments are kept in fp32 regardless of
param dtype — the "triple extra parameters" the paper's snapshots protect
(§6.1).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.spans import span
from repro_torch.core.treebytes import (leaf_arrays, torch_dtype,
                                        tree_map, tree_unflatten)


@dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moments_dtype: str = "float32"


def adam_init(params, cfg: AdamConfig | None = None):
    cfg = cfg if cfg is not None else AdamConfig()
    dt = torch_dtype(cfg.moments_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    step = torch.zeros((), dtype=torch.int32,
                       device=leaf_arrays(params)[0].device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": step}


def global_norm(tree):
    return torch.sqrt(sum(x.float().square().sum()
                          for x in leaf_arrays(tree)))


def adam_update(cfg: AdamConfig, grads, opt_state, params):
    """-> (new params, new opt_state, grad norm), all new tensors."""
    with span("optim.adam"):
        return _adam_update(cfg, grads, opt_state, params)


def _adam_update(cfg: AdamConfig, grads, opt_state, params):
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    def upd(g, mu, nu, p):
        mdt = mu.dtype
        g = g.float() * clip
        mu = cfg.b1 * mu.float() + (1 - cfg.b1) * g
        nu = cfg.b2 * nu.float() + (1 - cfg.b2) * g.square()
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        new_p = p.float() - cfg.lr * delta
        return new_p.to(p.dtype), mu.to(mdt), nu.to(mdt)

    out = [upd(g, mu, nu, p) for g, mu, nu, p in zip(
        leaf_arrays(grads), leaf_arrays(opt_state["mu"]),
        leaf_arrays(opt_state["nu"]), leaf_arrays(params))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_mu = tree_unflatten(params, [o[1] for o in out])
    new_nu = tree_unflatten(params, [o[2] for o in out])
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, gnorm
