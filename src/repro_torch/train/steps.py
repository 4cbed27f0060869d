"""Train / eval / prefill / decode step factories and the train state.

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
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.spans import span
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


@dataclass
class TrainState:
    """The reference's named view of the state tree (`init_train_state`
    returns the tree itself, the form every step and snapshot takes)."""
    params: Any
    opt_state: Any
    step: Any
    rng: Any

    def tree(self):
        return {"params": self.params, "opt_state": self.opt_state,
                "step": self.step, "rng": self.rng}

    @classmethod
    def from_tree(cls, t):
        return cls(params=t["params"], opt_state=t["opt_state"],
                   step=t["step"], rng=t["rng"])


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


def _value_and_grad(cfg, params, batch):
    """-> (loss, the gradient of each leaf of `params`, in leaf order)."""
    leaves = [p.detach().requires_grad_(True) for p in leaf_arrays(params)]
    loss, _ = M.forward(cfg, tree_unflatten(params, leaves), batch)
    with span("train.backward"):
        grads = list(torch.autograd.grad(loss, leaves))
    return loss.detach(), grads


def _accumulated_grads(cfg, params, batch, microbatches: int):
    """The reference's `accum_grads`: axis 0 of every batch entry split
    into `microbatches` equal chunks (an indivisible batch is refused),
    each chunk's gradients added into fp32 zeros on the params' device,
    then the loss and the gradients averaged."""
    def split(x):
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch of {b} rows does not split into "
                             f"{microbatches} microbatches")
        return x.reshape(microbatches, b // microbatches, *x.shape[1:])
    chunks = {k: split(v) for k, v in batch.items()}
    leaves = leaf_arrays(params)
    loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in leaves]
    for i in range(microbatches):
        loss_i, g_i = _value_and_grad(cfg, params,
                                      {k: v[i] for k, v in chunks.items()})
        with torch.no_grad():
            loss = loss + loss_i
            grads = [a + g for a, g in zip(grads, g_i)]
        del g_i
    inv = 1.0 / microbatches
    with torch.no_grad():
        return loss * inv, [g * inv for g in grads]


def apply_step(cfg: ModelConfig, opt: AdamConfig, state: dict,
               batch: dict, microbatches: int = 1) -> tuple:
    """The step's device work: the loss, its gradients (over
    `microbatches` chunks of the batch, `_accumulated_grads`) and the
    AdamW update -> (new params, new opt_state, metrics). Out of place.
    `make_train_step` adds the step counter and the rng fold; the
    dry-run traces this on DTensor state."""
    params = state["params"]
    if microbatches == 1:
        loss, grads = _value_and_grad(cfg, params, batch)
    else:
        loss, grads = _accumulated_grads(cfg, params, batch, microbatches)
    grads = tree_unflatten(params, grads)
    with torch.no_grad():
        new_params, new_opt, gnorm = adam_update(
            opt, grads, state["opt_state"], params)
    return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}


def make_train_step(cfg: ModelConfig, opt: AdamConfig | None = None,
                    microbatches: int = 1):
    """-> train_step(state, batch) -> (new state, metrics).  Out of
    place; the loss and grad norm are device scalars. `microbatches` > 1
    accumulates the gradients of equal chunks of the batch (the
    reference's knob for a step whose activations exceed the card's
    memory) and makes one update with their mean."""
    opt = opt if opt is not None else AdamConfig()

    def train_step(state: dict, batch: dict) -> tuple:
        with span("train.step"):
            new_params, new_opt, metrics = apply_step(cfg, opt, state, batch,
                                                      microbatches)
            with torch.no_grad():
                step = state["step"]
                with span("train.rng_fold"):        # the step's host sync
                    rng = torch.from_numpy(fold_in(
                        state["rng"].cpu().numpy(), int(step))).to(step.device)
                new_state = {
                    "params": new_params,
                    "opt_state": new_opt,
                    "step": step + 1,
                    "rng": rng,
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


def make_eval_step(cfg: ModelConfig):
    def eval_step(params, batch):
        with torch.no_grad():
            return M.forward(cfg, params, batch, remat=False)[0]
    return eval_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return M.logits_fn(cfg, params, batch)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, cache, tokens):
        return M.decode_step(cfg, params, cache, tokens)
    return serve_step
