"""Train-step factory and the train state.

The counterpart of `repro/train/steps.py`.  The train state is the exact
tree REFT snapshots — params + optimizer moments + step + data-RNG key (the
paper's "model parameters, optimizer states, and RNG states") — with the
reference's leaf layout: the `rng` leaf is a uint32[2] threefry key that
each step advances exactly as `jax.random.fold_in(rng, step)` does, so
whole flat streams compare byte for byte with the reference's.

`train_step` is out of place: it returns a new state and never writes a
leaf of the old one, so a snapshot in flight keeps reading step t.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.treebytes import leaf_arrays, tree_map, tree_unflatten
from repro_torch.models import model as M
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update

_M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key, x0: int, x1: int):
    """Threefry-2x32 (20 rounds) of one counter pair, as JAX's
    `threefry_2x32` computes it."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rots = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in rots[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for 0 <= seed < 2**32: [0, seed]."""
    return np.array([0, seed & _M32], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)` on a uint32[2] threefry key."""
    return np.array(threefry2x32(key, 0, int(data) & _M32), np.uint32)


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     device="cuda") -> dict:
    """Fresh state on `device`: weights from a torch.Generator seeded
    with `seed` (values differ from JAX's), zero moments, step 0, and
    rng = PRNGKey(seed + 1) as in the reference."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(cfg, gen, device)
    return {"params": params, "opt_state": adam_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "rng": torch.from_numpy(prng_key(seed + 1)).to(device)}


def apply_step(cfg: ModelConfig, opt: AdamConfig, state: dict,
               batch: dict) -> tuple:
    """The step's device work: the loss, its gradients and the AdamW
    update -> (new params, new opt_state, metrics). Out of place.
    `make_train_step` adds the step counter and the rng fold; the
    dry-run traces this on DTensor state."""
    params = state["params"]
    leaves = [p.detach().requires_grad_(True) for p in leaf_arrays(params)]
    live = tree_unflatten(params, leaves)
    loss, _ = M.forward(cfg, live, batch)
    grads = torch.autograd.grad(loss, leaves)
    grads = tree_unflatten(params, list(grads))
    with torch.no_grad():
        new_params, new_opt, gnorm = adam_update(
            opt, grads, state["opt_state"], params)
    return new_params, new_opt, {"loss": loss.detach(), "grad_norm": gnorm}


def make_train_step(cfg: ModelConfig, opt: AdamConfig | None = None):
    """-> train_step(state, batch) -> (new state, metrics).  Out of
    place; the loss and grad norm are device scalars."""
    opt = opt if opt is not None else AdamConfig()

    def train_step(state: dict, batch: dict) -> tuple:
        new_params, new_opt, metrics = apply_step(cfg, opt, state, batch)
        with torch.no_grad():
            step = state["step"]
            rng = fold_in(state["rng"].cpu().numpy(), int(step))
            new_state = {
                "params": new_params,
                "opt_state": new_opt,
                "step": step + 1,
                "rng": torch.from_numpy(rng).to(step.device),
            }
        return new_state, metrics

    return train_step


def with_step_boundary(step_fn: Callable,
                       notify: Callable[[], None] = None) -> Callable:
    """Yield hook for the HASC saving pipeline: wrap a step function so
    every call ticks the snapshot pipeline's step-boundary gate, and
    in-flight L1 device pumps schedule their bucket bursts at step
    boundaries (the reference's hook; `CheckpointSession.after_step`
    ticks it too, so only a loop that never calls it needs this)."""
    if notify is None:
        from repro_torch.core.pipeline import step_boundary as notify

    @functools.wraps(step_fn)
    def stepped(*args, **kw):
        out = step_fn(*args, **kw)
        notify()
        return out
    return stepped


def state_to(state: Any, device) -> Any:
    """The same tree with every leaf on `device`."""
    return tree_map(lambda t: t.to(device), state)
