"""Model assembly: init / forward / prefill / decode for the dense, MoE,
SSM and hybrid families, with the VLM (patch embeddings before the
tokens) and audio (frame embeddings, no tokens) inputs.

The counterpart of `repro/models/model.py`.  Parameters keep the
reference's period-stacked layout: a period of K layers
(`_stack_period`: K = 1 but for the hybrid family, whose period holds
attention, SSM and MoE layers), `params["blocks"]["pos0"]` ..
`["pos{K-1}"]` leaves of shape (n_periods, ...), so the flat byte streams
of the two packages line up leaf for leaf; the decode cache keeps it too
(`cache["entries"]["pos{i}"]["k"]` of shape (n_periods, B, S, KV, hd)).
The layer loop walks the periods, then the positions in each, on stacks
unbound once per call; `cfg.remat` maps to `torch.utils.checkpoint` per
layer.  Inside a `dist.use_mesh` context,
on DTensor params, the two `shard` calls of the reference (each layer's
input, the logits) redistribute the activations; elsewhere they are the
identity.  Serving (`logits_fn`, `init_cache`,
`decode_step`) runs under `torch.inference_mode()` and writes each
step's k/v (or SSM state) into the cache in place.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.core.spans import span
from repro_torch.core.treebytes import leaf_arrays, tree_unflatten
from repro_torch.dist.api import P, lookup, new_stack, shard
from repro_torch.models.attention import (
    attention, attention_decode, init_attn,
)
from repro_torch.models.layers import (
    FULL_WINDOW, chunked_cross_entropy, cross_entropy, dense_init, dtype_of,
    init_mlp, init_rms, mlp, pdtype_of, rms_norm,
)
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.models.ssm import init_ssm, ssm_block, ssm_decode

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def check_supported(cfg: ModelConfig) -> None:
    """Every family of the reference is ported: the dense family, with
    full or sliding-window attention (homogeneous as starcoder2, or local
    and global layers interleaved as gemma3), the MoE family (dbrx,
    kimi-k2: every layer's FFN a mixture of experts), the pure SSM family
    (Mamba2), the hybrid family (Jamba: attention, SSM and MoE layers in
    a period), and dense stacks fed by patch embeddings (VLM:
    phi-3-vision) or frame embeddings (audio: hubert, an encoder). A
    family outside these raises."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: ported are the dense (full or sliding-window "
            f"attention), MoE, SSM (Mamba2), hybrid (Jamba), VLM and audio "
            f"families; family {cfg.family!r} is unknown")


def _stack_period(cfg: ModelConfig):
    """(period, n_periods), the reference's: the hybrid family stacks by
    its attention period, taken to a multiple of the MoE stride so that
    every period repeats one pattern; every other family has period 1."""
    if cfg.family == "hybrid" and cfg.attn_period:
        period = cfg.attn_period
        if cfg.num_experts:
            period = math.lcm(period, cfg.moe_every)
        assert cfg.num_layers % period == 0, (cfg.name, period)
        return period, cfg.num_layers // period
    return 1, cfg.num_layers


def window_array(cfg: ModelConfig):
    """Each layer's attention window as a python int (FULL_WINDOW for a
    global layer): the reference's `window_array`, static here."""
    return [cfg.layer_window(i) or FULL_WINDOW
            for i in range(cfg.num_layers)]


def _band(cfg: ModelConfig, idx: int):
    """`cfg.banded_attention`'s static band for layer `idx`, as the
    reference takes it when the layer index is static (None: no band)."""
    if cfg.banded_attention and cfg.sliding_window is not None:
        return cfg.layer_window(idx)
    return None


def _init_stack(cfg: ModelConfig, gen, device):
    """{"pos{i}": position i's leaves stacked over the periods}. The
    layers are made in their order (period by period, each period's
    positions in turn), each written into its position's (n_periods, ...)
    stacks, allocated at the first period: one layer's tree at a time
    beside the stacks (stacking whole per-layer trees would hold the
    model twice)."""
    K, n = _stack_period(cfg)
    out, stacks = {}, []
    for period in range(n):
        for i in range(K):
            layer = _init_layer(cfg, gen, device, i)
            if period == 0:
                stacks.append([t.new_empty((n, *t.shape))
                               for t in leaf_arrays(layer)])
                out[f"pos{i}"] = tree_unflatten(layer, stacks[i])
            for s, t in zip(stacks[i], leaf_arrays(layer)):
                s[period] = t
            layer = None
    return out


def _unstack(tree, n: int):
    """The inverse of the stacking: n per-period trees (views, one unbind
    each)."""
    cols = [leaf.unbind(0) for leaf in leaf_arrays(tree)]
    return [tree_unflatten(tree, [c[i] for c in cols]) for i in range(n)]


def _periods(cfg: ModelConfig, stacked):
    """{"pos{i}": (n_periods, ...) leaves} -> for each period, its K
    layers' trees in position order: the layers in their global order."""
    K, n = _stack_period(cfg)
    cols = [_unstack(stacked[f"pos{i}"], n) for i in range(K)]
    return [[col[p] for col in cols] for p in range(n)]


def _init_layer(cfg: ModelConfig, gen, device, idx: int):
    """One layer's params at position `idx` of the period, which decides
    its kind (attention or SSM) and whether its FFN is a mixture of
    experts, as the reference's."""
    pd = pdtype_of(cfg)
    D = cfg.d_model
    p = {"ln1": init_rms(D, pd, device)}
    if cfg.layer_kind(idx) == ATTN:
        p["mix"] = init_attn(gen, cfg, device)
    else:
        p["mix"] = init_ssm(gen, cfg, device)
    if cfg.d_ff:
        p["ln2"] = init_rms(D, pd, device)
        p["ffn"] = (init_moe(gen, cfg, device) if cfg.layer_is_moe(idx)
                    else init_mlp(gen, cfg, device))
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, device):
    """The reference's leaves: `embed` when the inputs are tokens,
    `proj_in` (D, D) when they are embeddings (frames, or patches before
    the tokens), `lm_head` for an encoder or an untied head."""
    check_supported(cfg)
    pd = pdtype_of(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    params = {}
    if cfg.embed_inputs:
        params["embed"] = dense_init(gen, (V, D), pd, device, scale=0.02)
    if not cfg.embed_inputs or cfg.num_patches:
        params["proj_in"] = dense_init(gen, (D, D), pd, device)
    params["blocks"] = _init_stack(cfg, gen, device)
    params["final_norm"] = init_rms(D, pd, device)
    if cfg.is_encoder or not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (D, V), pd, device)
    return params


def _ffn(cfg, p, idx, h):
    """-> (h + the FFN's output, the router's aux loss: None but on a MoE
    layer). `idx`: the layer's position in the period."""
    # d_ff == 0 (Mamba2): no FFN; the reference adds zeros
    if not cfg.d_ff:
        return h, None
    # the layer input's layout again (no op outside a mesh): after the
    # mixer's row-parallel output DTensor would otherwise shard the
    # sequence over "model", which its matmul propagation cannot carry
    # through the flattened (B*S) rows; GSPMD needs no hint
    h = shard(h, P(("pod", "data"), None, None))
    h_in = rms_norm(h, p["ln2"])
    if cfg.layer_is_moe(idx):
        out, aux = moe_ffn(p["ffn"], cfg, h_in)
        return h + out, aux
    return h + mlp(p["ffn"], h_in), None


def _layer(cfg, p, idx, h, positions, window, band):
    """The layer at position `idx` of the period, on the full sequence.
    -> (h, aux (None but on a MoE layer), cache entry): the layer's
    (k, v), or its SSM (conv_state, h_final)."""
    with span("model.block"):
        h = shard(h, P(("pod", "data"), None, None))
        if cfg.layer_kind(idx) == ATTN:
            a, entry = attention(p["mix"], cfg, rms_norm(h, p["ln1"]),
                                 window=window, positions=positions,
                                 band=band)
        else:
            a, entry = ssm_block(p["mix"], cfg, rms_norm(h, p["ln1"]),
                                 chunk=cfg.ssd_chunk)
        return (*_ffn(cfg, p, idx, h + a), entry)


def _cache_names(cfg, idx):
    return ("k", "v") if cfg.layer_kind(idx) == ATTN else ("conv", "h")


def _run_blocks(cfg, params, h, *, collect_cache, remat):
    """The layer stack on the full sequence, period by period and each
    period's positions in turn: the global layer index picks the window
    and the band, the position the kind. -> (h, aux, caches): aux the sum
    of the MoE layers' aux losses (None without any); with
    `collect_cache`, {"pos{i}": {name: (n_periods, ...)}}, each layer's
    entry written into a stack allocated at the first period (so the
    stacks never sit beside a second copy), else {}."""
    K, n = _stack_period(cfg)
    positions = torch.arange(h.shape[1], device=h.device)
    windows = window_array(cfg)
    stacks, aux = {f"pos{i}": {} for i in range(K)}, None
    for period, layers in enumerate(_periods(cfg, params["blocks"])):
        for i, p in enumerate(layers):
            idx = period * K + i
            args = (cfg, p, i, h, positions, windows[idx], _band(cfg, idx))
            if remat:
                h, a, entry = checkpoint(_layer, *args, use_reentrant=False)
            else:
                h, a, entry = _layer(*args)
            if a is not None:
                aux = a if aux is None else aux + a
            if not collect_cache:
                continue
            st = stacks[f"pos{i}"]
            for name, t in zip(_cache_names(cfg, i), entry):
                if period == 0:
                    st[name] = new_stack(t, n)
                st[name][period] = t
    return h, aux, (stacks if collect_cache else {})


def _embed(cfg, params, tokens):
    return lookup(params["embed"], tokens.long()).to(dtype_of(cfg))


def embed_batch(cfg: ModelConfig, params, batch):
    """-> (x (B,S,D), labels, loss mask or None). VLM: the patches through
    `proj_in`, then the tokens' embeddings, and a mask that is False over
    the patch positions (built from the labels, so it keeps their
    sharding); audio: the frames through `proj_in` (and the batch's own
    mask, if any); text: the tokens' embeddings."""
    with span("model.embed"):
        return _embed_batch(cfg, params, batch)


def _embed_batch(cfg: ModelConfig, params, batch):
    dt = dtype_of(cfg)
    labels = batch.get("labels")
    if cfg.family == "vlm":
        patches = batch["patches"].to(dt) @ params["proj_in"]
        x = torch.cat([patches, _embed(cfg, params, batch["tokens"])], 1)
        n = patches.shape[1]
        mask = None if labels is None else torch.cat(
            [torch.zeros_like(labels[:, :n], dtype=torch.bool),
             torch.ones_like(labels[:, n:], dtype=torch.bool)], 1)
        return x, labels, mask
    if not cfg.embed_inputs:                    # audio frames
        return batch["frames"].to(dt) @ params["proj_in"], labels, \
            batch.get("mask")
    return _embed(cfg, params, batch["tokens"]), labels, None


def _lm_head_w(params):
    return params["lm_head"] if "lm_head" in params else params["embed"].T


def forward(cfg: ModelConfig, params, batch, *, collect_cache=False,
            remat=None):
    """Full-sequence forward. Returns (loss, aux_dict): the loss plus 0.01
    times the MoE layers' summed aux loss, aux_dict["aux"] that sum (0
    for the dense and SSM families, whose loss adds nothing); with
    `collect_cache`, aux_dict["cache"] holds the per-layer caches."""
    check_supported(cfg)
    h, labels, mask = embed_batch(cfg, params, batch)
    remat = cfg.remat if remat is None else remat
    h, aux, caches = _run_blocks(cfg, params, h, collect_cache=collect_cache,
                            remat=remat)
    h = rms_norm(h, params["final_norm"])
    with span("model.loss"):
        w_out = _lm_head_w(params)
        if cfg.chunked_ce:
            loss = chunked_cross_entropy(h, w_out, labels, cfg.chunked_ce,
                                         mask)
        else:
            logits = shard(h @ w_out, P(("pod", "data"), None, "model"))
            loss = cross_entropy(logits, labels, mask)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        else:
            loss = loss + 0.01 * aux
    out = {"loss": loss, "aux": aux}
    if collect_cache:
        out["cache"] = caches
    return loss, out


# ===================================================================== serve
@torch.inference_mode()
def logits_fn(cfg: ModelConfig, params, batch):
    """Last-position logits (B, 1, V) and the per-layer caches, stacked
    like the params (prefill)."""
    check_supported(cfg)
    h, _, caches = _run_blocks(cfg, params,
                               embed_batch(cfg, params, batch)[0],
                               collect_cache=True, remat=False)
    h = rms_norm(h[:, -1:, :], params["final_norm"])
    return h @ _lm_head_w(params), caches


def cache_len(cfg: ModelConfig, max_seq: int, idx: int = 0) -> int:
    """Slots of the attention cache at position `idx` of the period. With
    `window_kv_cache` a position gets a window-sized ring only when every
    layer stacked there has a window; any global layer keeps all
    `max_seq` slots. (The reference sizes the ring by the window of the
    position's first layer, so its global layers of gemma3 get the local
    layers' ring and decode departs from the forward; ROADMAP §3.)"""
    K, n = _stack_period(cfg)
    windows = [cfg.layer_window(p * K + idx) for p in range(n)]
    if cfg.window_kv_cache and None not in windows:
        return min(max_seq, max(windows))
    return max_seq


@torch.inference_mode()
def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, device):
    """Zeroed decode cache, stacked over the periods: {"entries":
    {"pos{i}": {"k", "v"} or {"conv", "h"}, by position i's kind},
    "index": 0-d int32}."""
    check_supported(cfg)
    dt = dtype_of(cfg)
    K, n = _stack_period(cfg)
    entries = {}
    for i in range(K):
        if cfg.layer_kind(i) == ATTN:
            shape = (n, batch_size, cache_len(cfg, max_seq, i),
                     cfg.num_kv_heads, cfg.head_dim)
            entries[f"pos{i}"] = {
                "k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
        else:
            ch = cfg.d_inner + 2 * cfg.ssm_state
            entries[f"pos{i}"] = {
                "conv": torch.zeros((n, batch_size, cfg.ssm_conv_width - 1,
                                     ch), dtype=dt, device=device),
                "h": torch.zeros((n, batch_size, cfg.ssm_heads,
                                  cfg.ssm_head_dim, cfg.ssm_state),
                                 dtype=torch.float32, device=device),
            }
    return {"entries": entries,
            "index": torch.zeros((), dtype=torch.int32, device=device)}


def _layer_decode(cfg, p, idx, h, window, index, entry):
    """One-token step of the layer at position `idx` against its cache
    slice (written in place)."""
    if cfg.layer_kind(idx) == ATTN:
        a = attention_decode(p["mix"], cfg, rms_norm(h, p["ln1"]),
                             entry["k"], entry["v"], window=window,
                             index=index)[0]
    else:
        a = ssm_decode(p["mix"], cfg, rms_norm(h, p["ln1"]), entry["conv"],
                       entry["h"])[0]
    return _ffn(cfg, p, idx, h + a)[0]


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One decode step. tokens: (B, 1) integer -> (logits (B,1,V), cache):
    the cache given, its entries written in place, with `index + 1`; the
    layers in the prefill's order (period, then position). Tokens only,
    as the reference's (a VLM's patches enter by the prefill; an encoder
    has no decode step)."""
    check_supported(cfg)
    K = _stack_period(cfg)[0]
    index = cache["index"]
    h = _embed(cfg, params, tokens)
    windows = window_array(cfg)
    for period, (layers, ents) in enumerate(zip(
            _periods(cfg, params["blocks"]),
            _periods(cfg, cache["entries"]))):
        for i, (p, e) in enumerate(zip(layers, ents)):
            h = _layer_decode(cfg, p, i, h, windows[period * K + i], index,
                              e)
    h = rms_norm(h, params["final_norm"])
    return h @ _lm_head_w(params), {"entries": cache["entries"],
                                    "index": index + 1}
