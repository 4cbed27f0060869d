"""Carry a state across from the JAX package.

`state_from_numpy(tree, device)` turns a tree of numpy arrays — the JAX
package's train state after `np.asarray` on each leaf — into the port's
tree of tensors, bit for bit.  numpy has no bfloat16 of its own (JAX's
come from `ml_dtypes`), so those leaves cross as their raw 16-bit words.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.treebytes import leaf_arrays, torch_dtype, tree_unflatten


def tensor_from_numpy(arr: np.ndarray, device="cuda") -> torch.Tensor:
    arr = np.array(arr, order="C", copy=True)      # keeps 0-d shapes
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr).view(torch_dtype(arr.dtype.name))
    return t.to(device)


def state_from_numpy(tree: Any, device="cuda") -> Any:
    return tree_unflatten(tree, [tensor_from_numpy(np.asarray(x), device)
                                 for x in leaf_arrays(tree)])
