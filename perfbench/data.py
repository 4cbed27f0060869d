"""Token batches from the seed (a frozen copy of the program's synthetic
stream): batch `index` of a run is drawn by numpy's default generator
seeded with `hash((seed, index)) % 2**31`, tokens then labels, each
uniform over the vocabulary. Every row differs; the same seed and index
give the same batch, so a restored run replays the batches it lost."""
from __future__ import annotations

import numpy as np


def batch_numpy(vocab: int, rows: int, seq: int, seed: int,
                index: int) -> dict:
    rng = np.random.default_rng(hash((int(seed), int(index))) % (2 ** 31))
    return {k: rng.integers(0, vocab, size=(rows, seq), dtype=np.int64)
            .astype(np.int32) for k in ("tokens", "labels")}


def batch(vocab: int, rows: int, seq: int, seed: int, index: int, device):
    import torch
    return {k: torch.from_numpy(v).to(device) for k, v in
            batch_numpy(vocab, rows, seq, seed, index).items()}
