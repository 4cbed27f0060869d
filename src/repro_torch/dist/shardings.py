"""Sharding rule tables: partition specs for params / state / batch / cache.

The counterpart of `repro/dist/shardings.py`, with the same tables over
the port's trees (whose leaf names and order are the reference's, since
the flat byte streams match). Rules are name-based over the last key of
each leaf path, expressed as a *tail* spec over the leaf's trailing dims:
the stacked layer axis adds a leading dim that is always replicated, and
`_pad` aligns the tail to the leaf's rank. `adapt_spec` later drops
anything the concrete mesh cannot honour (missing axes, non-dividing
dims), so the table can be written against the ideal production mesh.

Megatron-style tensor parallelism over "model": column-parallel input
projections shard their fan-out dim, row-parallel output projections their
fan-in dim. Batch dims shard over ("pod", "data").

Two opt-in rule tables compose on top:
  * FSDP (`cfg.fsdp`): every table-ruled param additionally shards one
    replicated trailing dim over the batch axes (ZeRO-3 style);
  * expert parallelism (`cfg.moe_ep`): stacked MoE expert leaves
    (`wi_gate`/`wi_up`/`wo` with a leading experts dim) shard experts
    over "model" and, under FSDP, their fan-in dim over the batch axes
    (the layout `models.moe.moe_ffn_ep` computes on).

`named` turns a spec tree into `NamedSharding` leaves adapted to a mesh;
`distribute` places a tree of tensors as DTensors by them.
"""
from __future__ import annotations

import re
from typing import Any, Dict

from repro_torch.core.treebytes import (leaf_arrays, tree_flatten_with_path,
                                        tree_map, tree_unflatten)
from repro_torch.dist.api import NamedSharding, P, adapt_spec

# name -> spec over the leaf's trailing dims (rank-2/3 tails)
_PARAM_TAILS: Dict[str, tuple] = {
    # attention: qkv column-parallel, output row-parallel
    "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
    "wo": ("model", None),
    # dense / MoE FFN (moe adds a leading experts dim via _pad)
    "wi_gate": (None, "model"), "wi_up": (None, "model"),
    # SSM: fused in_proj is row-sharded on d_model, out_proj on d_inner
    "in_proj": ("model", None), "out_proj": ("model", None),
    "conv_w": (None, "model"),
    # embeddings / heads: shard the d_model dim (always 16-divisible)
    "embed": (None, "model"), "lm_head": ("model", None),
    "proj_in": (None, "model"),
}

_BATCH_AXES = ("pod", "data")

# stacked expert leaves (leading dim = num_experts) under cfg.moe_ep
_EP_LEAVES = ("wi_gate", "wi_up", "wo")

_KEY = re.compile(r"\['([^']*)'\]")


def _with_fsdp(tail: tuple, axis) -> tuple:
    """FSDP rule: shard the first replicated dim of the tail over the
    data axis (the tensor-parallel dim keeps "model")."""
    out = list(tail)
    for i, e in enumerate(out):
        if e is None:
            out[i] = axis
            return tuple(out)
    return tail


def _leaf_name(path: str) -> str:
    """The last string dict key of a keystr path (list indices skipped)."""
    keys = _KEY.findall(path)
    return keys[-1] if keys else ""


def _pad(tail: tuple, ndim: int) -> P:
    """Right-align a tail spec inside an ndim-rank leaf (leading dims:
    layer stacks, expert stacks, stay replicated)."""
    if ndim < len(tail):
        return P(*tail[len(tail) - ndim:])
    return P(*((None,) * (ndim - len(tail)) + tail))


def param_specs(cfg, shapes) -> Any:
    """Spec tree matching the params tree (leaf for leaf); `shapes` is any
    tree whose leaves have `.shape` (tensors, fake or meta tensors)."""
    ep = bool(getattr(cfg, "moe_ep", False))
    n_exp = int(getattr(cfg, "num_experts", 0) or 0)
    fsdp = _BATCH_AXES if getattr(cfg, "fsdp", False) else None
    specs = []
    for path, leaf in tree_flatten_with_path(shapes):
        name = _leaf_name(path)
        nd = len(leaf.shape)
        if (ep and n_exp > 1 and name in _EP_LEAVES and nd >= 3
                and leaf.shape[nd - 3] == n_exp):
            # stacked expert leaf (E, fan-in, fan-out): experts over
            # "model", fan-in over the data axes under FSDP
            specs.append(_pad(("model", fsdp, None), nd))
            continue
        tail = _PARAM_TAILS.get(name)
        if not (tail and nd):
            specs.append(P())
            continue
        if fsdp:
            tail = _with_fsdp(tail, fsdp)
        specs.append(_pad(tail, nd))
    return tree_unflatten(shapes, specs)


def state_specs(cfg, state) -> dict:
    """Specs for the full train state; optimizer moments mirror params."""
    p = param_specs(cfg, state["params"])
    return {
        "params": p,
        "opt_state": {"mu": p, "nu": p, "step": P()},
        "step": P(),
        "rng": P(),
    }


def batch_specs(cfg, batch) -> dict:
    """Inputs shard their leading (global batch) dim over ("pod","data")."""
    return {k: P(_BATCH_AXES, *((None,) * (len(v.shape) - 1)))
            if len(v.shape) else P()
            for k, v in batch.items()}


def cache_specs(cfg, cache, global_batch: int, mesh) -> Any:
    """Decode caches shard their batch dim; everything else replicates."""
    def spec(leaf):
        sh = leaf.shape
        if len(sh) >= 2 and sh[1] == global_batch:      # (layers, B, ...)
            return P(None, _BATCH_AXES, *((None,) * (len(sh) - 2)))
        if len(sh) >= 1 and sh[0] == global_batch:
            return P(_BATCH_AXES, *((None,) * (len(sh) - 1)))
        return P()
    return tree_map(spec, cache)


def named(specs, shapes, mesh) -> Any:
    """Spec tree -> `NamedSharding` tree, adapted to `mesh`."""
    return tree_unflatten(shapes, [
        NamedSharding(mesh, adapt_spec(sp, sh.shape, mesh))
        for sp, sh in zip(leaf_arrays(specs), leaf_arrays(shapes))])


def distribute(tree, shardings) -> Any:
    """Place every tensor of `tree` as a DTensor by its `NamedSharding`
    (`torch.distributed.tensor.distribute_tensor`: each rank keeps its own
    slab of the tensor it holds)."""
    from torch.distributed.tensor import distribute_tensor
    return tree_unflatten(tree, [
        distribute_tensor(t, ns.mesh, ns.placements)
        for t, ns in zip(leaf_arrays(tree), leaf_arrays(shardings))])
