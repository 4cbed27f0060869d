"""Deterministic synthetic data pipeline.

The counterpart of `repro/data/pipeline.py`: the same numpy batches, from
the same `hash((seed, step))` seeding, as tensors on the trainer's device.
The modality carve-out is the reference's: audio and VLM configs take
precomputed frame or patch embeddings of the documented shape instead of
raw media, drawn as standard normals in the batch's key order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.treebytes import torch_dtype


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.family == "vlm":
        return seq_len - cfg.num_patches
    return seq_len


def batch_shapes(cfg: ModelConfig, shape: InputShape) -> dict:
    """Name -> (shape, dtype name) for the given (arch, input-shape), in
    the reference's key order: a VLM batch's patch embeddings come before
    its tokens (and its labels span patches and tokens), an audio batch
    has frame embeddings and no tokens."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((B, 1), "int32")}
    out = {}
    if cfg.family == "vlm":
        out["patches"] = ((B, cfg.num_patches, cfg.d_model), cfg.dtype)
        out["tokens"] = ((B, _text_len(cfg, S)), "int32")
    elif not cfg.embed_inputs:                  # audio frames
        out["frames"] = ((B, S, cfg.d_model), cfg.dtype)
    else:
        out["tokens"] = ((B, S), "int32")
    out["labels"] = ((B, S), "int32")
    return out


def make_batch_numpy(cfg: ModelConfig, shape: InputShape,
                     seed: int = 0) -> dict:
    """The reference's batch values, as numpy, drawn in its order: integer
    entries as int32, embeddings as float32 (numpy has no bfloat16; the
    reference's `jnp.asarray(x, bfloat16)` rounds float64 to float32
    first, then to bfloat16, and `make_batch` takes the second step)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (s, d) in batch_shapes(cfg, shape).items():
        if d == "int32":
            hi = cfg.vocab_size if k in ("tokens", "labels") else 2
            out[k] = rng.integers(0, hi, size=s, dtype=np.int64) \
                .astype(np.int32)
        else:
            out[k] = rng.standard_normal(s).astype(np.float32)
    return out


def make_batch(cfg: ModelConfig, shape: InputShape, seed: int = 0,
               device="cuda") -> dict:
    """Concrete deterministic batch on `device`, embeddings in the
    config's dtype (bit for bit the reference's)."""
    dtypes = {k: d for k, (_, d) in batch_shapes(cfg, shape).items()}
    return {k: torch.from_numpy(v).to(device=device,
                                      dtype=torch_dtype(dtypes[k]))
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
