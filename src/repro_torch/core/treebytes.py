"""Flat byte-stream view of a train-state tree of tensors.

REFT shards, XOR-encodes, and snapshots *byte ranges*, not tensors: the whole
state (params + optimizer moments + step + RNG key) is laid out as one
contiguous logical byte stream so that (a) SG members get exactly-equal
orthogonal shards, (b) RAIM5 parity blocks line up across nodes, and
(c) restore is a single pass.  A JSON-able spec records (path, shape,
dtype, offset) per leaf.

The stream is byte-for-byte the one the JAX package (`repro`) lays out for
the same state, so either package restores the other's snapshots:

  * leaf order is JAX's pytree flatten order — dict keys SORTED, lists and
    tuples in order (PyTorch's own pytree keeps dict insertion order);
  * paths are `jax.tree_util.keystr` strings, e.g. `['opt_state']['mu']`;
  * dtypes are numpy dtype names (`float32`, `bfloat16`, `uint32`, ...);
  * `treedef_repr` is the `PyTreeDef({...})` string JAX prints.

Leaves are torch tensors (any device) or numpy arrays; numpy itself has no
bfloat16, so the bytes of every leaf travel as uint8 and are viewed back
through torch.
"""
from __future__ import annotations

import json
import zlib
from dataclasses import dataclass
from typing import Any, Iterator, List, Tuple

import numpy as np
import torch

# numpy dtype name <-> torch dtype for every leaf type a train state holds
_TORCH_OF = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "uint32": torch.uint32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float32": torch.float32,
    "float64": torch.float64,
}
_NAME_OF = {v: k for k, v in _TORCH_OF.items()}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH_OF[name]
    except KeyError:
        raise TypeError(f"unsupported leaf dtype {name!r}") from None


def dtype_name(leaf: Any) -> str:
    """numpy-style dtype name of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        try:
            return _NAME_OF[leaf.dtype]
        except KeyError:
            raise TypeError(f"unsupported leaf dtype {leaf.dtype}") from None
    return np.asarray(leaf).dtype.name


def dtype_itemsize(name: str) -> int:
    return torch_dtype(name).itemsize


# ------------------------------------------------------------ tree walking
def _children(node: Any):
    """(key string, child) pairs in JAX flatten order, or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def _walk(node, path: str, out: list) -> None:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append((path, node))
        return
    for k, c in kids:
        _walk(c, path + k, out)


def tree_flatten_with_path(tree: Any) -> List[Tuple[str, Any]]:
    """[(keystr path, leaf)] in JAX's flatten order (None is an empty
    subtree, as in JAX). A module-level walk: a recursive closure over
    the list would hold every leaf in a reference cycle until the next
    collection."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, "", out)
    return out


def treedef_repr(tree: Any) -> str:
    """The string `str(jax.tree_util.tree_structure(tree))` gives."""

    def rep(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {rep(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(rep(c) for c in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(rep(c) for c in node)
            return "(" + inner + ("," if len(node) == 1 else "") + ")"
        return "*"

    return f"PyTreeDef({rep(tree)})"


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """Rebuild `template`'s structure with `leaves` (flatten order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn, tree: Any) -> Any:
    return tree_unflatten(tree, [fn(x) for x in leaf_arrays(tree)])


# ---------------------------------------------------------------- the spec
@dataclass(frozen=True)
class LeafSpec:
    path: str
    shape: Tuple[int, ...]
    dtype: str
    offset: int
    nbytes: int


@dataclass(frozen=True)
class FlatSpec:
    leaves: Tuple[LeafSpec, ...]
    total_bytes: int
    treedef_repr: str

    def to_json(self) -> str:
        return json.dumps({
            "total_bytes": self.total_bytes,
            "treedef": self.treedef_repr,
            "leaves": [[l.path, list(l.shape), l.dtype, l.offset, l.nbytes]
                       for l in self.leaves],
        })

    @classmethod
    def from_json(cls, s: str) -> "FlatSpec":
        d = json.loads(s)
        leaves = tuple(LeafSpec(p, tuple(sh), dt, off, nb)
                       for p, sh, dt, off, nb in d["leaves"])
        return cls(leaves=leaves, total_bytes=d["total_bytes"],
                   treedef_repr=d["treedef"])


def make_flat_spec(tree: Any) -> FlatSpec:
    leaves: List[LeafSpec] = []
    off = 0
    for path, leaf in tree_flatten_with_path(tree):
        if not isinstance(leaf, torch.Tensor):
            leaf = np.asarray(leaf)
        name = dtype_name(leaf)
        shape = tuple(int(s) for s in leaf.shape)
        nbytes = int(np.prod(shape)) * dtype_itemsize(name) if shape \
            else dtype_itemsize(name)
        leaves.append(LeafSpec(path, shape, name, off, nbytes))
        off += nbytes
    return FlatSpec(tuple(leaves), off, treedef_repr(tree))


def leaf_arrays(tree: Any) -> List[Any]:
    """Leaves in the same order as the spec."""
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tensor_u8(t: torch.Tensor) -> torch.Tensor:
    """Flat uint8 view of a tensor's bytes (same device, no copy when
    contiguous; bool is already one byte per element)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def host_bytes(leaf: Any) -> np.ndarray:
    """A leaf's bytes as a host uint8 array (a blocking d2h for a device
    tensor; a zero-copy view for a contiguous host tensor)."""
    if isinstance(leaf, torch.Tensor):
        return tensor_u8(leaf.detach()).cpu().numpy()
    return np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)


def tensor_from_bytes(raw: np.ndarray, dtype: str,
                      shape: Tuple[int, ...]) -> torch.Tensor:
    """uint8 bytes -> a host tensor of `dtype`/`shape` owning a copy."""
    t = torch.from_numpy(np.array(raw, dtype=np.uint8, copy=True))
    return t.view(torch_dtype(dtype)).reshape(shape)


def tree_to_buffer(tree: Any, spec: FlatSpec, out: np.ndarray,
                   lo: int = 0, hi: int = None) -> None:
    """Copy the byte range [lo, hi) of the flat stream into `out` (uint8,
    length hi-lo). Device->host transfer happens leaf by leaf."""
    hi = spec.total_bytes if hi is None else hi
    assert out.nbytes >= hi - lo
    for ls, leaf in zip(spec.leaves, leaf_arrays(tree)):
        a, b = max(lo, ls.offset), min(hi, ls.offset + ls.nbytes)
        if a >= b:
            continue
        raw = host_bytes(leaf)[a - ls.offset:b - ls.offset]
        out[a - lo:b - lo] = raw


def buffer_to_tree(template: Any, spec: FlatSpec, buf: np.ndarray) -> Any:
    """Rebuild a tree (host tensor leaves) from the full flat buffer."""
    assert buf.nbytes >= spec.total_bytes
    out = [tensor_from_bytes(buf[ls.offset:ls.offset + ls.nbytes],
                             ls.dtype, ls.shape) for ls in spec.leaves]
    return tree_unflatten(template, out)


def iter_buckets(lo: int, hi: int, bucket_bytes: int
                 ) -> Iterator[Tuple[int, int]]:
    """Tiny-bucket ranges covering [lo, hi) (paper §4.1)."""
    a = lo
    while a < hi:
        b = min(a + bucket_bytes, hi)
        yield a, b
        a = b


def crc32_of(buf: np.ndarray) -> int:
    return zlib.crc32(buf.tobytes()) & 0xFFFFFFFF


def state_crc(tree: Any) -> int:
    """CRC32 of a tree's whole flat stream, leaf by leaf (no full-size
    host buffer)."""
    crc = 0
    for leaf in leaf_arrays(tree):
        crc = zlib.crc32(host_bytes(leaf), crc)
    return crc & 0xFFFFFFFF
