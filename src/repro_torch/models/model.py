"""Model assembly: init / forward for the dense and SSM families.

The counterpart of `repro/models/model.py`.  Parameters keep the
reference's stacked layout — `params["blocks"]["pos0"][...]` leaves of
shape (num_layers, ...) — so the flat byte streams of the two packages
line up leaf for leaf.  The layer loop unbinds the stacks once per
forward; `cfg.remat` maps to `torch.utils.checkpoint` per layer.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.core.treebytes import leaf_arrays, tree_unflatten
from repro_torch.models.attention import attention, init_attn
from repro_torch.models.layers import (
    FULL_WINDOW, chunked_cross_entropy, cross_entropy, dense_init, dtype_of,
    init_mlp, init_rms, mlp, pdtype_of, rms_norm,
)
from repro_torch.models.ssm import init_ssm, ssm_block


def check_supported(cfg: ModelConfig) -> None:
    """Ported: the dense family, with full or sliding-window attention
    (homogeneous as starcoder2, or local and global layers interleaved as
    gemma3), and the pure SSM family (Mamba2). Any other family raises,
    naming the ROADMAP item it waits for."""
    if cfg.family == "hybrid":
        why = ("the hybrid family (Jamba) waits for ROADMAP 'The remaining "
               "model families', after MoE")
    elif cfg.num_experts:
        why = "MoE waits for ROADMAP 'The remaining model families'"
    elif cfg.family == "vlm" or cfg.num_patches:
        why = "VLM inputs wait for ROADMAP 'The remaining model families'"
    elif cfg.family == "audio" or cfg.is_encoder or not cfg.embed_inputs:
        why = "audio inputs wait for ROADMAP 'The remaining model families'"
    elif cfg.family in ("dense", "ssm"):
        return
    else:
        why = f"family {cfg.family!r} is unknown"
    raise NotImplementedError(
        f"{cfg.name}: ported are the dense (full or sliding-window "
        f"attention) and SSM (Mamba2) families; {why}")


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


def _stack(trees):
    """Stack per-layer trees leaf-wise along a new axis 0."""
    cols = zip(*(leaf_arrays(t) for t in trees))
    return tree_unflatten(trees[0], [torch.stack(c) for c in cols])


def _unstack(tree, n: int):
    """The inverse of `_stack`: n per-layer trees (views, one unbind each)."""
    cols = [leaf.unbind(0) for leaf in leaf_arrays(tree)]
    return [tree_unflatten(tree, [c[i] for c in cols]) for i in range(n)]


def _init_layer(cfg: ModelConfig, gen, device):
    """One layer's params. Stacks have period 1 (no hybrid yet), so every
    layer is of the kind at position 0."""
    pd = pdtype_of(cfg)
    D = cfg.d_model
    p = {"ln1": init_rms(D, pd, device)}
    if cfg.layer_kind(0) == ATTN:
        p["mix"] = init_attn(gen, cfg, device)
    else:
        p["mix"] = init_ssm(gen, cfg, device)
    if cfg.d_ff:
        p["ln2"] = init_rms(D, pd, device)
        p["ffn"] = init_mlp(gen, cfg, device)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, device):
    check_supported(cfg)
    pd = pdtype_of(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    params = {"embed": dense_init(gen, (V, D), pd, device, scale=0.02)}
    params["blocks"] = {"pos0": _stack([_init_layer(cfg, gen, device)
                                        for _ in range(cfg.num_layers)])}
    params["final_norm"] = init_rms(D, pd, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (D, V), pd, device)
    return params


def _layer(cfg, p, h, positions, window, band):
    if cfg.layer_kind(0) == ATTN:
        h = h + attention(p["mix"], cfg, rms_norm(h, p["ln1"]),
                          window=window, positions=positions, band=band)
    else:
        h = h + ssm_block(p["mix"], cfg, rms_norm(h, p["ln1"]),
                          chunk=cfg.ssd_chunk)[0]
    # d_ff == 0 (Mamba2): no FFN; the reference adds zeros
    if cfg.d_ff:
        h = h + mlp(p["ffn"], rms_norm(h, p["ln2"]))
    return h


def forward(cfg: ModelConfig, params, batch, *, remat=None):
    """Full-sequence forward. Returns (loss, aux_dict)."""
    check_supported(cfg)
    h = params["embed"][batch["tokens"].long()].to(dtype_of(cfg))
    labels = batch["labels"]
    positions = torch.arange(h.shape[1], device=h.device)
    remat = cfg.remat if remat is None else remat
    windows = window_array(cfg)
    for i, p in enumerate(_unstack(params["blocks"]["pos0"],
                                   cfg.num_layers)):
        args = (cfg, p, h, positions, windows[i], _band(cfg, i))
        if remat:
            h = checkpoint(_layer, *args, use_reentrant=False)
        else:
            h = _layer(*args)
    h = rms_norm(h, params["final_norm"])
    w_out = params["lm_head"] if "lm_head" in params else params["embed"].T
    if cfg.chunked_ce:
        loss = chunked_cross_entropy(h, w_out, labels, cfg.chunked_ce)
    else:
        loss = cross_entropy(h @ w_out, labels)
    return loss, {"loss": loss}
