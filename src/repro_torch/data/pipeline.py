"""Deterministic synthetic data pipeline.

The counterpart of `repro/data/pipeline.py`: the same numpy batches, from
the same `hash((seed, step))` seeding, as tensors on the trainer's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig


def batch_shapes(cfg: ModelConfig, shape: InputShape) -> dict:
    """Name -> (shape, dtype name) of a text training batch (the dense
    family; image and audio inputs come with their model families)."""
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": ((B, S), "int32"), "labels": ((B, S), "int32")}


def make_batch_numpy(cfg: ModelConfig, shape: InputShape,
                     seed: int = 0) -> dict:
    """The reference's batch values, as numpy."""
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, size=s, dtype=np.int64)
            .astype(np.int32) for k, (s, _) in batch_shapes(cfg, shape).items()}


def make_batch(cfg: ModelConfig, shape: InputShape, seed: int = 0,
               device="cuda") -> dict:
    """Concrete deterministic batch on `device`."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in make_batch_numpy(cfg, shape, seed).items()}


class SyntheticDataset:
    """Deterministic, restartable token stream.

    `state()`/`restore()` give the exact RNG position — this is the "RNG
    state" the paper's snapshots must capture for bit-exact resume.
    """

    def __init__(self, cfg: ModelConfig, shape: InputShape, seed: int = 0,
                 device="cuda"):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.device = device
        self._step = 0

    def state(self) -> dict:
        return {"seed": self.seed, "step": self._step}

    def restore(self, state: dict) -> None:
        self.seed = int(state["seed"])
        self._step = int(state["step"])

    def __next__(self) -> dict:
        batch = make_batch(self.cfg, self.shape,
                           seed=hash((self.seed, self._step)) % (2 ** 31),
                           device=self.device)
        self._step += 1
        return batch

    def __iter__(self):
        return self
