"""Model assembly: init / forward / prefill / decode for the dense, MoE
and SSM families, with the VLM (patch embeddings before the tokens) and
audio (frame embeddings, no tokens) inputs.

The counterpart of `repro/models/model.py`.  Parameters keep the
reference's stacked layout — `params["blocks"]["pos0"][...]` leaves of
shape (num_layers, ...) — so the flat byte streams of the two packages
line up leaf for leaf; the decode cache keeps it too
(`cache["entries"]["pos0"]["k"]` of shape (num_layers, B, S, KV, hd)).
The layer loop unbinds the stacks once per call; `cfg.remat` maps to
`torch.utils.checkpoint` per layer.  Inside a `dist.use_mesh` context,
on DTensor params, the two `shard` calls of the reference (each layer's
input, the logits) redistribute the activations; elsewhere they are the
identity.  Serving (`logits_fn`, `init_cache`,
`decode_step`) runs under `torch.inference_mode()` and writes each
step's k/v (or SSM state) into the cache in place.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, ModelConfig
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


def check_supported(cfg: ModelConfig) -> None:
    """Ported: the dense family, with full or sliding-window attention
    (homogeneous as starcoder2, or local and global layers interleaved as
    gemma3), the MoE family (dbrx, kimi-k2: every layer's FFN a
    mixture of experts), the pure SSM family (Mamba2), and dense stacks
    fed by patch embeddings (VLM: phi-3-vision) or frame embeddings
    (audio: hubert, an encoder). The hybrid family raises, naming the
    ROADMAP item it waits for."""
    if cfg.family == "hybrid":
        why = ("the hybrid family (Jamba: attention, SSM and MoE layers "
               "in a period) waits for ROADMAP 'The hybrid family', the "
               "next slice")
    elif cfg.family in ("dense", "moe", "ssm", "vlm", "audio"):
        return
    else:
        why = f"family {cfg.family!r} is unknown"
    raise NotImplementedError(
        f"{cfg.name}: ported are the dense (full or sliding-window "
        f"attention), MoE, SSM (Mamba2), VLM and audio families; {why}")


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
    """`_init_layer` for each layer in turn, its leaves written into
    (num_layers, ...) stacks allocated at the first layer: one layer's
    tree at a time beside the stacks (stacking whole per-layer trees
    would hold the model twice)."""
    first = _init_layer(cfg, gen, device)
    stacks = [t.new_empty((cfg.num_layers, *t.shape))
              for t in leaf_arrays(first)]
    out = tree_unflatten(first, stacks)
    for i in range(cfg.num_layers):
        layer = first if i == 0 else _init_layer(cfg, gen, device)
        for s, t in zip(stacks, leaf_arrays(layer)):
            s[i] = t
        first = layer = None
    return out


def _unstack(tree, n: int):
    """The inverse of `_stack`: n per-layer trees (views, one unbind each)."""
    cols = [leaf.unbind(0) for leaf in leaf_arrays(tree)]
    return [tree_unflatten(tree, [c[i] for c in cols]) for i in range(n)]


def _init_layer(cfg: ModelConfig, gen, device):
    """One layer's params. Stacks have period 1 (no hybrid yet), so every
    layer is of the kind at position 0, and its FFN a mixture of experts
    when position 0's is (the reference passes the position in the
    period)."""
    pd = pdtype_of(cfg)
    D = cfg.d_model
    p = {"ln1": init_rms(D, pd, device)}
    if cfg.layer_kind(0) == ATTN:
        p["mix"] = init_attn(gen, cfg, device)
    else:
        p["mix"] = init_ssm(gen, cfg, device)
    if cfg.d_ff:
        p["ln2"] = init_rms(D, pd, device)
        p["ffn"] = (init_moe(gen, cfg, device) if cfg.layer_is_moe(0)
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
    params["blocks"] = {"pos0": _init_stack(cfg, gen, device)}
    params["final_norm"] = init_rms(D, pd, device)
    if cfg.is_encoder or not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (D, V), pd, device)
    return params


def _ffn(cfg, p, h):
    """-> (h + the FFN's output, the router's aux loss: None but on a MoE
    layer)."""
    # d_ff == 0 (Mamba2): no FFN; the reference adds zeros
    if not cfg.d_ff:
        return h, None
    # the layer input's layout again (no op outside a mesh): after the
    # mixer's row-parallel output DTensor would otherwise shard the
    # sequence over "model", which its matmul propagation cannot carry
    # through the flattened (B*S) rows; GSPMD needs no hint
    h = shard(h, P(("pod", "data"), None, None))
    h_in = rms_norm(h, p["ln2"])
    if cfg.layer_is_moe(0):
        out, aux = moe_ffn(p["ffn"], cfg, h_in)
        return h + out, aux
    return h + mlp(p["ffn"], h_in), None


def _layer(cfg, p, h, positions, window, band):
    """One layer on the full sequence. -> (h, aux (None but on a MoE
    layer), cache entry): the layer's (k, v), or its SSM (conv_state,
    h_final)."""
    h = shard(h, P(("pod", "data"), None, None))
    if cfg.layer_kind(0) == ATTN:
        a, entry = attention(p["mix"], cfg, rms_norm(h, p["ln1"]),
                             window=window, positions=positions, band=band)
    else:
        a, entry = ssm_block(p["mix"], cfg, rms_norm(h, p["ln1"]),
                             chunk=cfg.ssd_chunk)
    return (*_ffn(cfg, p, h + a), entry)


def _cache_names(cfg):
    return ("k", "v") if cfg.layer_kind(0) == ATTN else ("conv", "h")


def _run_blocks(cfg, params, h, *, collect_cache, remat):
    """The layer stack on the full sequence. -> (h, aux, caches): aux the
    sum of the MoE layers' aux losses (None without any); with
    `collect_cache`, {"pos0": {name: (num_layers, ...)}}, each layer's
    entry written into a stack allocated at the first layer (so the
    stacks never sit beside a second copy), else {}."""
    positions = torch.arange(h.shape[1], device=h.device)
    windows = window_array(cfg)
    stacks, aux = {}, None
    for i, p in enumerate(_unstack(params["blocks"]["pos0"],
                                   cfg.num_layers)):
        args = (cfg, p, h, positions, windows[i], _band(cfg, i))
        if remat:
            h, a, entry = checkpoint(_layer, *args, use_reentrant=False)
        else:
            h, a, entry = _layer(*args)
        if a is not None:
            aux = a if aux is None else aux + a
        if not collect_cache:
            continue
        for name, t in zip(_cache_names(cfg), entry):
            if i == 0:
                stacks[name] = new_stack(t, cfg.num_layers)
            stacks[name][i] = t
    return h, aux, ({"pos0": stacks} if collect_cache else {})


def _embed(cfg, params, tokens):
    return lookup(params["embed"], tokens.long()).to(dtype_of(cfg))


def embed_batch(cfg: ModelConfig, params, batch):
    """-> (x (B,S,D), labels, loss mask or None). VLM: the patches through
    `proj_in`, then the tokens' embeddings, and a mask that is False over
    the patch positions (built from the labels, so it keeps their
    sharding); audio: the frames through `proj_in` (and the batch's own
    mask, if any); text: the tokens' embeddings."""
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


def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    """Slots of each attention layer's cache. With `window_kv_cache` a
    stack position gets a window-sized ring only when every layer stacked
    there has a window; any global layer keeps all `max_seq` slots. (The
    reference sizes the ring by the window of the position's first
    layer, so its global layers of gemma3 get the local layers' ring and
    decode departs from the forward; ROADMAP §3.)"""
    windows = [cfg.layer_window(i) for i in range(cfg.num_layers)]
    if cfg.window_kv_cache and None not in windows:
        return min(max_seq, max(windows))
    return max_seq


@torch.inference_mode()
def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, device):
    """Zeroed decode cache, stacked over the layers: {"entries": {"pos0":
    {"k", "v"} or {"conv", "h"}}, "index": 0-d int32}."""
    check_supported(cfg)
    dt, L = dtype_of(cfg), cfg.num_layers
    if cfg.layer_kind(0) == ATTN:
        shape = (L, batch_size, cache_len(cfg, max_seq), cfg.num_kv_heads,
                 cfg.head_dim)
        entry = {"k": torch.zeros(shape, dtype=dt, device=device),
                 "v": torch.zeros(shape, dtype=dt, device=device)}
    else:
        ch = cfg.d_inner + 2 * cfg.ssm_state
        entry = {
            "conv": torch.zeros((L, batch_size, cfg.ssm_conv_width - 1, ch),
                                dtype=dt, device=device),
            "h": torch.zeros((L, batch_size, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
        }
    return {"entries": {"pos0": entry},
            "index": torch.zeros((), dtype=torch.int32, device=device)}


def _layer_decode(cfg, p, h, window, index, entry):
    """One-token step against this layer's cache slice (written in
    place)."""
    if cfg.layer_kind(0) == ATTN:
        a = attention_decode(p["mix"], cfg, rms_norm(h, p["ln1"]),
                             entry["k"], entry["v"], window=window,
                             index=index)[0]
    else:
        a = ssm_decode(p["mix"], cfg, rms_norm(h, p["ln1"]), entry["conv"],
                       entry["h"])[0]
    return _ffn(cfg, p, h + a)[0]


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One decode step. tokens: (B, 1) integer -> (logits (B,1,V), cache):
    the cache given, its entries written in place, with `index + 1`.
    Tokens only, as the reference's (a VLM's patches enter by the
    prefill; an encoder has no decode step)."""
    check_supported(cfg)
    L, index = cfg.num_layers, cache["index"]
    h = _embed(cfg, params, tokens)
    windows = window_array(cfg)
    for i, (p, e) in enumerate(zip(_unstack(params["blocks"]["pos0"], L),
                                   _unstack(cache["entries"]["pos0"], L))):
        h = _layer_decode(cfg, p, h, windows[i], index, e)
    h = rms_norm(h, params["final_norm"])
    return h @ _lm_head_w(params), {"entries": cache["entries"],
                                    "index": index + 1}
