"""Mesh-aware sharding primitives on torch's DeviceMesh and DTensor.

The counterpart of `repro/dist/api.py`. `shard(x, spec)` is the single
annotation primitive the model code uses: inside a mesh context, on a
DTensor, it redistributes `x` to the spec after adapting it to the axes
the active mesh actually has; outside any mesh, or on a plain tensor (CPU
runs, the REFT training driver), it is the identity, so the same model
code runs everywhere.

`P` stands in for JAX's `PartitionSpec` (torch has none): one entry per
tensor dim, each an axis name, a tuple of axis names or None
(replicated). It is a leaf of the port's trees, not a tuple, so spec
trees keep the state's structure.

`adapt_spec` implements the adaptation rules of the reference, unchanged:
  * axis names the mesh does not have are dropped;
  * an axis (or tuple prefix) only survives if its cumulative size divides
    the corresponding array dimension: the longest dividing prefix.

A mesh is a `DeviceMesh` (axes from `mesh_dim_names`, sizes from its
shape) or any object with `axis_names` and `axis_sizes`, as the
reference's tests use.

The rest are the model code's DTensor helpers: on a plain tensor each is
the op it stands for, value for value; on DTensors each does what GSPMD
does for the reference where DTensor (of the torch versions the port
runs on) would refuse the op, pick a layout that later ops cannot carry,
or give a malformed placement.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Iterator, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


class P:
    """A partition spec: `P("data", None)`, `P(("pod", "data"), "model")`,
    `P()` (replicated)."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(tuple(e) if isinstance(e, list) else e
                             for e in entries)

    def __iter__(self) -> Iterator:
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self.entries)) + ")"


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def axis_sizes(mesh) -> Tuple[int, ...]:
    sizes = getattr(mesh, "axis_sizes", None)
    if sizes is None:
        sizes = mesh.shape
    return tuple(int(s) for s in sizes)


_ACTIVE = threading.local()


def _active_mesh():
    """The mesh of the enclosing `use_mesh` context, or None outside any."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make `mesh` the active mesh for `shard` (nestable, per thread)."""
    stack = getattr(_ACTIVE, "stack", None)
    if stack is None:
        stack = _ACTIVE.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def adapt_spec(spec: P, shape: Sequence[int], mesh) -> P:
    """Drop spec axes the mesh lacks or whose size does not divide the dim."""
    sizes = dict(zip(axis_names(mesh), axis_sizes(mesh)))
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        kept, prod = [], 1
        for nm in names:
            if nm not in sizes:
                continue                     # axis not on this mesh
            if shape[dim] % (prod * sizes[nm]) != 0:
                break                        # longest dividing prefix only
            kept.append(nm)
            prod *= sizes[nm]
        if not kept:
            out.append(None)
        elif isinstance(entry, tuple):
            out.append(tuple(kept))
        else:
            out.append(kept[0])
    return P(*out)


def placements(spec: P, mesh) -> tuple:
    """An adapted spec -> one DTensor placement per mesh dim: `Shard(d)`
    on each mesh dim named in tensor dim d's entry (a tuple entry shards
    d over each of its axes, in mesh order), `Replicate()` elsewhere and
    on a mesh dim of one rank (a shard over one rank is its replica, and
    DTensor then has nothing to redistribute)."""
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    out = [Replicate()] * len(names)
    index = {nm: i for i, nm in enumerate(names)}
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for nm in (entry if isinstance(entry, tuple) else (entry,)):
            if sizes[index[nm]] > 1:
                out[index[nm]] = Shard(dim)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec adapted to a mesh (JAX's `NamedSharding`), with the DTensor
    placements it stands for."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def shard(x: Any, spec: P) -> Any:
    """Redistribute the DTensor `x` to `spec` on the active mesh (the
    identity without a mesh, or on a plain tensor)."""
    mesh = _active_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    sp = adapt_spec(spec, x.shape, mesh)
    if all(e is None for e in sp):
        return x
    want = placements(sp, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


# ------------------------------------------------------ DTensor helpers
def _contiguous(shape) -> tuple:
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return tuple(stride)


def _reshape_dtensor(x, shape):
    try:
        return x.reshape(*shape)
    except RuntimeError:
        first = 0
        while (first < min(x.dim(), len(shape))
               and x.shape[first] == shape[first]):
            first += 1
        want = tuple(Replicate() if p.is_shard() and p.dim >= first else p
                     for p in x.placements)
        if want == tuple(x.placements):
            raise
        return x.redistribute(x.device_mesh, want).reshape(*shape)


class _Reshape(torch.autograd.Function):
    """A DTensor reshape whose gradient reshapes back by the same rule
    (autograd's own view backward would meet the same refusal)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return _reshape_dtensor(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape_dtensor(g, ctx.shape), None


def reshape(x: Any, *shape) -> Any:
    """`x.reshape(*shape)`. On a DTensor whose shard DTensor cannot carry
    through the view (a sharded dim split so that its first part does not
    divide by the mesh dim, as KV 8 heads over 16 ranks), the mesh dims
    sharding the dims the view changes are replicated first (in the
    forward and in the gradient): the resharding GSPMD inserts."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    return _Reshape.apply(x, tuple(shape))


def _all_reduce(t, op: str, groups) -> torch.Tensor:
    """`t` reduced by `op` over each (mesh, mesh dim) of `groups`, as
    functional collectives (those DTensor's redistributions issue)."""
    from torch.distributed import _functional_collectives as funcol
    for g in groups:
        t = funcol.all_reduce(t, op, g)
        if isinstance(t, funcol.AsyncCollectiveTensor):
            t = t.wait()
    return t


class _Psum(torch.autograd.Function):
    """The sum of local tensors over `groups`, whose gradient is the
    (replicated) cotangent itself: each rank's input is its share of a
    sum every rank then holds."""

    @staticmethod
    def forward(ctx, t, groups):
        return _all_reduce(t, "sum", groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(t: torch.Tensor, groups) -> torch.Tensor:
    """JAX's `psum` inside `shard_map`, over each (mesh, mesh dim) of
    `groups`, with the transpose a replicated gradient needs (the
    identity)."""
    return _Psum.apply(t, tuple(groups)) if groups else t


def _wait(t):
    from torch.distributed import _functional_collectives as funcol
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


class _AllGather(torch.autograd.Function):
    """Local shards gathered along `dim` over each (mesh, mesh dim) of
    `groups`, innermost mesh dim first (DTensor's layout of a dim
    sharded over several mesh dims); the gradient is reduce-scattered
    back, outermost first."""

    @staticmethod
    def forward(ctx, t, dim, groups):
        from torch.distributed import _functional_collectives as funcol
        ctx.dim, ctx.groups = dim, groups
        for g in reversed(groups):
            t = _wait(funcol.all_gather_tensor(t.contiguous(), dim, g))
        return t

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol
        for grp in ctx.groups:
            g = _wait(funcol.reduce_scatter_tensor(g.contiguous(), "sum",
                                                   ctx.dim, grp))
        return g, None, None


def all_gather(t: torch.Tensor, dim: int, groups) -> torch.Tensor:
    """JAX's tiled `all_gather` over the mesh axes `groups` (FSDP's
    gather of a weight's shards), whose transpose is a reduce-scatter."""
    return _AllGather.apply(t, dim, tuple(groups)) if groups else t


class _VocabNLL(torch.autograd.Function):
    """Per-position NLL in fp32 of local (..., v) logits holding columns
    [offset, offset + v) of a vocabulary split over `groups`: each rank
    reduces its own columns (the max, the sum of exponentials, the
    label's logit where it owns the label's column) and all-reduces the
    (...) results; the gradient, softmax minus the label's one-hot, is
    local. With no groups it is the plain NLL."""

    @staticmethod
    def forward(ctx, logits, labels, groups, offset):
        v = logits.shape[-1]
        m = _all_reduce(logits.amax(-1).float(), "max", groups)
        # one fp32 copy of the logits at a time, worked in place
        e = logits.to(torch.float32, copy=True).sub_(m[..., None]).exp_()
        logz = m + torch.log(_all_reduce(e.sum(-1), "sum", groups))
        del e
        idx = labels.long() - offset
        own = (idx >= 0) & (idx < v)
        idx = idx.clamp(0, v - 1)
        tgt = torch.gather(logits, -1, idx[..., None])[..., 0].float()
        tgt = _all_reduce(torch.where(own, tgt, torch.zeros_like(tgt)),
                          "sum", groups)
        ctx.save_for_backward(logits, idx, own, logz)
        return logz - tgt

    @staticmethod
    def backward(ctx, g):
        logits, idx, own, logz = ctx.saved_tensors
        d = logits.to(torch.float32, copy=True).sub_(logz[..., None]).exp_()
        d.scatter_add_(-1, idx[..., None], -own.float()[..., None])
        return d.mul_(g[..., None]).to(logits.dtype), None, None, None


def _shard_offset(size: int, mesh, dims) -> int:
    """This rank's first index along a tensor dim of `size` split over
    the mesh dims `dims` in order (DTensor's chunking: ceil-sized
    pieces)."""
    coord = mesh.get_coordinate()
    offset = 0
    for i in dims:
        chunk = -(-size // mesh.size(i))
        offset += coord[i] * chunk
        size = max(0, min(chunk, size - coord[i] * chunk))
    return offset


def vocab_nll(logits: Any, labels: Any) -> Any:
    """Per-position negative log-likelihood in fp32: logits (..., V),
    labels (...) integer. On DTensors the vocabulary dim stays split as
    the logits hold it (the model axis, as the reference's
    `shard(logits, P(..., "model"))` lays it out): each rank works on its
    own columns and only (...)-sized results are all-reduced; the rows
    keep their shards of the leading dims, and any other mesh dim is
    replicated first."""
    if not isinstance(logits, DTensor):
        return _VocabNLL.apply(logits, labels, (), 0)
    mesh = logits.device_mesh
    vd = logits.dim() - 1
    want, rows, groups = [], [], []
    for i, p in enumerate(logits.placements):
        if p.is_shard() and p.dim < vd:
            want.append(p)
            rows.append(p)
        elif p.is_shard(vd):
            want.append(p)
            rows.append(Replicate())
            groups.append(i)
        else:
            want.append(Replicate())
            rows.append(Replicate())
    if tuple(want) != tuple(logits.placements):
        logits = logits.redistribute(mesh, want)
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    if tuple(labels.placements) != tuple(rows):
        labels = labels.redistribute(mesh, rows)
    nll = _VocabNLL.apply(logits.to_local(grad_placements=want),
                          labels.to_local(),
                          tuple((mesh, i) for i in groups),
                          _shard_offset(logits.shape[vd], mesh, groups))
    shape = tuple(labels.shape)
    return DTensor.from_local(nll, mesh, rows, run_check=False, shape=shape,
                              stride=_contiguous(shape))


def new_stack(t: Any, n: int) -> Any:
    """An uninitialised (n, *t.shape) stack for n tensors like `t`. On a
    DTensor the stack is laid out as `t` is, one dim further in (a
    DTensor factory op would replicate it: every rank would hold every
    row)."""
    if not isinstance(t, DTensor):
        return t.new_empty((n, *t.shape))
    local = t.to_local()
    shape = (n, *t.shape)
    return DTensor.from_local(
        local.new_empty((n, *local.shape)), t.device_mesh,
        [Shard(p.dim + 1) if p.is_shard() else p for p in t.placements],
        run_check=False, shape=shape, stride=_contiguous(shape))


def lookup(table: Any, ids: Any) -> Any:
    """`table[ids]`: the rows of a (V, D) table. On a DTensor table whose
    vocabulary dim is whole, each rank gathers its own rows (ids sharded
    over the batch axes) of its own columns (the table's D shard) with
    no communication; the table's gradient is a partial sum over the
    ranks that gathered different rows. (DTensor's own rule for this
    index leaves the backward a scatter some torch versions cannot
    place.) A table whose vocabulary dim is sharded (FSDP's rule) is
    gathered whole along it first, as FSDP gathers a weight before it is
    used; that redistribution's backward reduce-scatters the gradient."""
    if not isinstance(table, DTensor) or any(
            p.is_partial() for p in table.placements):
        return table[ids]
    mesh = table.device_mesh
    if any(p.is_shard(0) for p in table.placements):
        table = table.redistribute(mesh, [Replicate() if p.is_shard(0)
                                          else p for p in table.placements])
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    want, out, grad = [], [], []
    for t, i in zip(table.placements, ids.placements):
        if t.is_shard():                 # the table's D: every row, its D
            want.append(Replicate())
            out.append(Shard(ids.dim()))
            grad.append(t)
        elif i.is_shard(0):              # this rank's rows, every column
            want.append(i)
            out.append(Shard(0))
            grad.append(Partial())
        else:
            want.append(Replicate())
            out.append(Replicate())
            grad.append(Replicate())
    if tuple(want) != tuple(ids.placements):
        ids = ids.redistribute(mesh, want)
    local = table.to_local(grad_placements=grad)[ids.to_local()]
    shape = (*ids.shape, table.shape[1])
    return DTensor.from_local(local, mesh, out, run_check=False,
                              shape=shape, stride=_contiguous(shape))


def split(x: Any, sizes, dim: int = -1) -> tuple:
    """`torch.split(x, sizes, dim)`; on a DTensor, as slices (some torch
    versions' DTensor rule for `split_with_sizes` gives its outputs one
    placement where the mesh has several)."""
    if not isinstance(x, DTensor):
        return torch.split(x, sizes, dim=dim)
    d = dim % x.dim()
    out, lo = [], 0
    for n in sizes:
        out.append(x[(slice(None),) * d + (slice(lo, lo + n),)])
        lo += n
    return tuple(out)


def index_copy_(x: Any, dim: int, index: Any, src: Any) -> Any:
    """`x.index_copy_(dim, index, src)`. On a DTensor `x` (not sharded
    along `dim`), `src` laid out as `x` and the write made shard by
    shard: some torch versions' DTensor has no rule for it."""
    if not isinstance(x, DTensor):
        return x.index_copy_(dim, index, src)
    d = dim % x.dim()
    if any(p.is_shard(d) for p in x.placements):
        raise ValueError(f"index_copy_ along dim {d}, which {x.placements} "
                         f"shards")
    if isinstance(index, DTensor):
        index = index.full_tensor()
    if tuple(src.placements) != tuple(x.placements):
        src = src.redistribute(x.device_mesh, x.placements)
    x.to_local().index_copy_(d, index, src.to_local())
    return x


def zero_pad(x: Any, pads) -> Any:
    """`F.pad(x, pads)` with zeros. On a DTensor, as a `cat` with zeros
    (some torch versions' DTensor rule for `constant_pad_nd` gives its
    output one placement where the mesh has several)."""
    if not isinstance(x, DTensor):
        return F.pad(x, pads)
    for i in range(len(pads) // 2):
        d = x.dim() - 1 - i
        parts = []
        for n in (pads[2 * i], pads[2 * i + 1]):
            shape = list(x.shape)
            shape[d] = n
            parts.append(x.new_zeros(shape) if n else None)
        x = torch.cat([t for t in (parts[0], x, parts[1]) if t is not None],
                      dim=d)
    return x
