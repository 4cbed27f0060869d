"""Top-k mixture-of-experts with capacity-based gather dispatch.

The counterpart of `repro/models/moe.py`, the same function: the router
(an fp32 (D, E) product, softmax, top k, weights renormalised) picks k
experts a token; the (token, expert) pairs are sorted stably by expert
and ranked within each expert; the first C of each expert are gathered
into an (E, C+1, D) buffer (slot C is the overflow's and always holds
zeros, as does any slot past an expert's count); three batched products
per expert; each token's k rows are weighted and summed. Dropped pairs
contribute zero.

Every index is arithmetic on static shapes (a stable sort, a
`searchsorted`, gathers): no `nonzero`, `unique` or boolean masks, so
the dry-run's fake tensors trace it. The gathers are an autograd
Function whose backward is again a gather and a sum over a fixed axis
(`_gather_rows`), never an `index_add_`: the dispatch and the combine
give the same bits on every run, on the card too.

Routes:
  * `moe_ffn_gspmd`, the reference's baseline, on plain tensors; on
    DTensors (inside `dist.use_mesh`) the routing and the gathers run on
    every rank over all tokens and the expert products on DTensors laid
    out as the reference's constraints put them (experts over "model",
    capacity over "data");
  * `moe_ffn_ep`, explicit expert parallelism (the reference's
    `shard_map`): each rank routes its own token shard, keeps the pairs
    of its own E / model experts (the others go to the trash expert),
    gathers the FSDP shards of its experts, and the partial outputs are
    summed over "model" (`dist.api.psum`, whose gradient is the
    replicated cotangent). Without a mesh, on plain tensors, or when the
    experts or the tokens do not divide, it is the GSPMD route, as the
    reference's fallback is.

`TOUCHED` (`ExpertTouchTracker`) records which experts the router picked
since the last snapshot flight, for `--delta`'s dirty provider: a device
mask of E bools set by `index_fill_` (no sync), copied to the host once
a flight by `consume()`.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.analyze.lockgraph import named_lock
from repro_torch.dist.api import (P, _active_mesh, all_gather, axis_names,
                                  axis_sizes, psum, reshape, shard)
from repro_torch.models.layers import dense_init, pdtype_of


def init_moe(gen, cfg, device):
    """The router is fp32 whatever the model's type; the experts are
    (E, D, F) / (E, F, D)."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    pd = pdtype_of(cfg)
    return {
        "router": dense_init(gen, (D, E), torch.float32, device),
        "wi_gate": dense_init(gen, (E, D, Fd), pd, device),
        "wi_up": dense_init(gen, (E, D, Fd), pd, device),
        "wo": dense_init(gen, (E, Fd, D), pd, device),
    }


def _capacity(T, k, E, factor):
    return max(1, int(math.ceil(T * k / E * factor)))


class _GatherRows(torch.autograd.Function):
    """out[m] = x[idx[m]], with idx == len(x) selecting a zero row. The
    gradient is a gather too: dx[n] = sum over j of g[back[n, j]] (back
    lists the m with idx[m] == n, padded with len(g), a zero row), summed
    over the fixed axis j."""

    @staticmethod
    def forward(ctx, x, idx, back):
        ctx.save_for_backward(back)
        return torch.cat([x, x.new_zeros((1, x.shape[1]))])[idx]

    @staticmethod
    def backward(ctx, g):
        (back,) = ctx.saved_tensors
        g = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        return g[back].sum(1), None, None


def _gather_rows(x, idx, back):
    return _GatherRows.apply(x, idx, back)


def _plan(sel, E_loc: int, C: int):
    """The dispatch's indices for (T, k) expert ids (ids >= E_loc go to
    the trash expert: kept by no slot). -> (disp (E_loc*(C+1),): the
    token each slot reads, T for an empty slot; slot (T, k): each pair's
    slot, E_loc*(C+1) for a dropped pair; pair (E_loc*(C+1), 1): the
    pair in each slot, T*k for none)."""
    T, k = sel.shape
    Tk, dev = T * k, sel.device
    eids = sel.reshape(Tk)
    eids = torch.where(eids < E_loc, eids, torch.full_like(eids, E_loc))
    order = torch.sort(eids, stable=True).indices
    sorted_eids = eids[order]
    start = torch.searchsorted(
        sorted_eids, torch.arange(E_loc + 1, device=dev, dtype=eids.dtype))
    rank = torch.arange(Tk, device=dev) - start[sorted_eids]
    keep = (rank < C) & (sorted_eids < E_loc)
    nslots = E_loc * (C + 1)
    slot_sorted = torch.where(keep, sorted_eids * (C + 1) + rank,
                              torch.full_like(rank, nslots))
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    # slot c of expert e holds sorted pair start[e] + c while c < its count
    c = torch.arange(C + 1, device=dev)
    count = torch.clamp(start[1:] - start[:-1], max=C)
    j = torch.where(c[None, :] < count[:, None], start[:-1, None] + c,
                    torch.full((E_loc, C + 1), Tk, device=dev,
                               dtype=start.dtype))
    pair = torch.cat([order, order.new_full((1,), Tk)])[j.reshape(nslots)]
    return pair // k, slot.reshape(T, k), pair.reshape(nslots, 1)


def _experts(xe, wi_gate, wi_up, wo):
    h = F.silu(torch.bmm(xe, wi_gate)) * torch.bmm(xe, wi_up)
    return torch.bmm(h, wo)


def _dispatch_compute(xf, w, sel, wi_gate, wi_up, wo, C, experts=None):
    """Capacity-gather dispatch + expert products + weighted combine.

    xf: (T, D); w/sel: (T, k) routing weights / expert ids (ids may
    exceed the local expert count E_loc = wi_gate.shape[0]: those pairs
    are dropped, which is how the expert-parallel route drops non-local
    pairs). `experts(xe)` maps the (E_loc, C+1, D) buffer to the experts'
    outputs (default: the three products on these weights). -> (T, D)."""
    T, D = xf.shape
    E_loc, k = wi_gate.shape[0], sel.shape[1]
    disp, slot, pair = _plan(sel, E_loc, C)
    xe = _gather_rows(xf, disp, slot).view(E_loc, C + 1, D)
    ye = (experts or (lambda t: _experts(t, wi_gate, wi_up, wo)))(xe)
    rows = _gather_rows(ye.reshape(E_loc * (C + 1), D), slot.reshape(T * k),
                        pair)
    wk = (w * (slot < E_loc * (C + 1))).to(rows.dtype)
    return (rows.view(T, k, D) * wk[..., None]).sum(1)


class ExpertTouchTracker:
    """Aggregates which experts the router selected since the last
    snapshot flight (the dirty-delta saving path's provider signal).

    Disabled by default (`record` returns at once). The router feeds
    every `sel` through `record`, which sets the experts' entries of a
    mask on `sel`'s device with `index_fill_` (no host sync); the
    snapshot path calls `consume()` at flight time for the touched
    mask (one copy to the host) and resets it.
    """

    def __init__(self):
        self._lock = named_lock("moe.touched")
        self._n = 0
        self._mask = None
        self.enabled = False

    def enable(self, num_experts: int) -> "ExpertTouchTracker":
        with self._lock:
            self._n = int(num_experts)
            self._mask = None
            self.enabled = True
        return self

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            self._n = 0
            self._mask = None

    def record(self, sel) -> None:
        """Fold a (T, k) routed-expert id tensor into the mask."""
        if not self.enabled:
            return
        with self._lock:
            if not self.enabled:
                return
            if self._mask is None:
                self._mask = torch.zeros(self._n, dtype=torch.bool,
                                         device=sel.device)
            ids = sel.detach().reshape(-1).to(self._mask.device)
            self._mask.index_fill_(0, ids, True)

    def consume(self) -> np.ndarray:
        """Return-and-reset the aggregated touched mask."""
        with self._lock:
            if self._mask is None:
                return np.zeros(self._n, bool)
            m = self._mask.to("cpu", copy=True).numpy()
            self._mask.zero_()
            return m

    def peek(self) -> np.ndarray:
        with self._lock:
            if self._mask is None:
                return np.zeros(self._n, bool)
            return self._mask.to("cpu", copy=True).numpy()


# module-level singleton: the router is a plain function, so dirtiness
# aggregation has to live beside it rather than in model state
TOUCHED = ExpertTouchTracker()


def _fp32_product(x, router):
    """x @ router in full fp32 (no TF32), whatever the process's
    matmul precision: routes are decided by it."""
    prev = torch.get_float32_matmul_precision()
    if prev == "highest":
        return x @ router
    torch.set_float32_matmul_precision("highest")
    try:
        return x @ router
    finally:
        torch.set_float32_matmul_precision(prev)


def _route(router, cfg, xf):
    """-> probs (T, E), w (T, k) renormalised, sel (T, k). The top k by
    a stable descending sort: a tie goes to the lower expert, as
    `jax.lax.top_k` breaks it."""
    probs = torch.softmax(_fp32_product(xf.float(), router), dim=-1)
    w, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    w, sel = w[:, :k], sel[:, :k]
    w = w / w.sum(-1, keepdim=True)
    TOUCHED.record(sel)
    return probs, w, sel


def _aux_loss(cfg, probs, sel):
    """Switch-style load-balance auxiliary loss."""
    E = cfg.num_experts
    me = probs.mean(0)                                       # (E,)
    ids = sel.reshape(-1)
    counts = torch.zeros(E, dtype=torch.float32, device=probs.device) \
        .index_add_(0, ids, torch.ones(ids.shape, dtype=torch.float32,
                                       device=probs.device))
    return E * torch.sum(me * counts / sel.shape[0]) / cfg.experts_per_token


def _replicated(t):
    """A DTensor's whole value on this rank (plain tensors pass)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh,
                          [Replicate()] * t.device_mesh.ndim).to_local()


def _gspmd_dtensor(p, cfg, x, C):
    """The GSPMD route on DTensors: the tokens, the router and the
    dispatch's gathers whole on every rank; the expert products on
    DTensors sharded as the reference's constraints (experts over
    "model", capacity over "data")."""
    from torch.distributed.tensor import DTensor, Replicate
    B, S, D = x.shape
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    xf = _replicated(x).reshape(B * S, D)
    probs, w, sel = _route(_replicated(p["router"]), cfg, xf)

    def experts(xe):
        xe = shard(DTensor.from_local(xe, mesh, rep, run_check=False),
                   P("model", "data", None))
        h = F.silu(torch.bmm(xe, p["wi_gate"])) * torch.bmm(xe, p["wi_up"])
        h = shard(h, P("model", "data", None))
        ye = shard(torch.bmm(h, p["wo"]), P("model", "data", None))
        return _replicated(ye)

    y = _dispatch_compute(xf, w, sel, p["wi_gate"], p["wi_up"], p["wo"], C,
                          experts=experts)
    y = DTensor.from_local(y.reshape(B, S, D).to(x.dtype), mesh, rep,
                           run_check=False)
    aux = DTensor.from_local(_aux_loss(cfg, probs, sel), mesh, rep,
                             run_check=False)
    return shard(y, P(("data",), None, None)), aux


def moe_ffn_gspmd(p, cfg, x):
    """GSPMD-inferred dispatch (baseline). x: (B,S,D) -> (y, aux)."""
    from torch.distributed.tensor import DTensor
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    C = _capacity(T, k, E, cfg.capacity_factor)
    if cfg.moe_pad_capacity:
        # keep the (C+1)-slot dispatch buffer divisible by the data axis
        # so the capacity dim stays shardable
        m = cfg.moe_pad_capacity
        C = -(-(C + 1) // m) * m - 1
    if isinstance(x, DTensor):
        return _gspmd_dtensor(p, cfg, x, C)
    xf = x.reshape(T, D)
    probs, w, sel = _route(p["router"], cfg, xf)
    y = _dispatch_compute(xf, w, sel, p["wi_gate"], p["wi_up"], p["wo"], C)
    return y.reshape(B, S, D).to(x.dtype), _aux_loss(cfg, probs, sel)


def _local(t, mesh, want, grad):
    """`t` laid out as `want` on `mesh`, then its local shard, whose
    gradient DTensor reads as `grad`."""
    if tuple(t.placements) != tuple(want):
        t = t.redistribute(mesh, want)
    return t.to_local(grad_placements=grad)


def moe_ffn_ep(p, cfg, x):
    """Explicit expert-parallel MoE (the reference's `shard_map`).

    Tokens stay sharded over the batch axes ("pod", "data"); expert
    weights are sharded over "model" (FSDP shards over the batch axes are
    all-gathered locally, `dist.api.all_gather`, whose gradient is a
    reduce-scatter); each rank runs the local capacity-gather dispatch
    for its E / model experts on its own token shard (capacity from the
    local token count), and the partial outputs are summed over "model".
    The aux loss is each rank's over its tokens, averaged over the batch
    axes. Every sum's gradient is the replicated cotangent, so the local
    gradients of the replicated router and tokens are each rank's share
    (DTensor `Partial`) of the whole.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = _active_mesh()
    if mesh is None or not isinstance(x, DTensor) \
            or "model" not in axis_names(mesh):
        return moe_ffn_gspmd(p, cfg, x)
    mesh = x.device_mesh
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    names = axis_names(mesh)
    sizes = dict(zip(names, axis_sizes(mesh)))
    ep = sizes["model"] if E % sizes["model"] == 0 else 1
    if ep == 1:
        return moe_ffn_gspmd(p, cfg, x)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = math.prod(sizes[a] for a in dp_axes) if dp_axes else 1
    if (B * S) % dp:
        return moe_ffn_gspmd(p, cfg, x)
    T_loc = B * S // dp
    C_loc = _capacity(T_loc, k, E, cfg.capacity_factor)
    fsdp = dp_axes if cfg.fsdp else ()
    dp_groups = tuple((mesh, names.index(a)) for a in dp_axes)
    fsdp_groups = tuple((mesh, names.index(a)) for a in fsdp)
    model = (mesh, names.index("model"))

    def placed(dp_place, model_place):
        return [dp_place if nm in dp_axes else
                model_place if nm == "model" else Replicate()
                for nm in names]

    xt = reshape(x, B * S, D)
    xl = _local(xt, mesh, placed(Shard(0), Replicate()),
                placed(Shard(0), Partial()))
    router = _local(p["router"], mesh, [Replicate()] * mesh.ndim,
                    [Partial()] * mesh.ndim)
    w_place = placed(Shard(1) if fsdp else Replicate(), Shard(0))
    w_grad = placed(Shard(1) if fsdp else Partial(), Shard(0))
    wg, wu, wo = (all_gather(_local(p[n], mesh, w_place, w_grad), 1,
                             fsdp_groups)
                  for n in ("wi_gate", "wi_up", "wo"))
    E_loc = wg.shape[0]
    probs, w, sel = _route(router, cfg, xl)
    m_idx = mesh.get_coordinate()[model[1]]
    sel_loc = torch.where(sel // E_loc == m_idx, sel % E_loc,
                          torch.full_like(sel, E_loc))
    y = psum(_dispatch_compute(xl, w, sel_loc, wg, wu, wo, C_loc), (model,))
    aux = psum(psum(_aux_loss(cfg, probs, sel) / ep, (model,)) / dp,
               dp_groups)
    y = DTensor.from_local(y.to(x.dtype), mesh, placed(Shard(0), Replicate()),
                           run_check=False)
    aux = DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return reshape(y, B, S, D), aux


def moe_ffn(p, cfg, x):
    """x: (B, S, D) -> (B, S, D), plus router aux loss."""
    if cfg.moe_ep:
        return moe_ffn_ep(p, cfg, x)
    return moe_ffn_gspmd(p, cfg, x)
