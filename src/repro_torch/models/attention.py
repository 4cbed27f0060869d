"""GQA attention with RoPE, optional qk-norm and sliding windows.

The counterpart of `repro/models/attention.py`: the masked softmax below
`FLASH_THRESHOLD`, flash attention at and above it (or for any length
when a static band is asked for), through
`kernels.swa_attention.swa_flash`: the CUDA kernels on the card, their
plain version on the CPU.  Decode (`attention_decode`) attends one query
against a preallocated KV cache, in plain PyTorch as the reference's
plain `jnp` (no Pallas kernel there).
"""
from __future__ import annotations

import torch

from repro_torch.dist.api import index_copy_, reshape
from repro_torch.kernels.swa_attention import swa_flash
from repro_torch.models.layers import (
    apply_rope, dense_init, init_rms, pdtype_of, rms_norm, rope_angles,
)

NEG_INF = -1e30
# Above this sequence length the online-softmax path is used so the
# (S, S) score matrix is never materialized.
FLASH_THRESHOLD = 2048


def init_attn(gen, cfg, device):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pd = pdtype_of(cfg)
    p = {
        "wq": dense_init(gen, (D, H * hd), pd, device),
        "wk": dense_init(gen, (D, KV * hd), pd, device),
        "wv": dense_init(gen, (D, KV * hd), pd, device),
        "wo": dense_init(gen, (H * hd, D), pd, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rms(hd, pd, device)
        p["k_norm"] = init_rms(hd, pd, device)
    return p


def _project_qkv(p, cfg, x, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = reshape(x @ p["wq"], B, S, H, hd)
    k = reshape(x @ p["wk"], B, S, KV, hd)
    v = reshape(x @ p["wv"], B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


def _gqa_scores(q, k, cfg):
    """q: (B,Sq,H,hd), k: (B,Sk,KV,hd) -> (B,KV,G,Sq,Sk) fp32 (products
    of the working dtype are exact in fp32, as JAX's
    preferred_element_type=float32)."""
    B, Sq, H, hd = q.shape
    KV = cfg.num_kv_heads
    qg = reshape(q, B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    return s * (hd ** -0.5)


def _mix(scores, v, cfg):
    """scores: (B,KV,G,Sq,Sk) fp32, v: (B,Sk,KV,hd) -> (B,Sq,H*hd)."""
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    B, Sq = o.shape[0], o.shape[1]
    return reshape(o, B, Sq, cfg.num_heads * cfg.head_dim)


def attention(p, cfg, x, *, window, positions, band=None):
    """Full-sequence attention (training / prefill).

    window: int (FULL_WINDOW for global layers).
    positions: (S,) integer tensor (contiguous from 0 for the flash path).
    band: the static window of `cfg.banded_attention`, as the reference
    takes it: it sends any length down the flash path. There the window
    is always static, so out-of-band KV tiles are skipped either way.
    Returns (out, (k, v)) so prefill can populate the cache.
    """
    q, k, v = _project_qkv(p, cfg, x, positions)
    B, S = x.shape[0], x.shape[1]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if S >= FLASH_THRESHOLD or band is not None:
        qg = reshape(q, B, S, KV, H // KV, hd)
        o = swa_flash(qg, k, v, window=window, causal=cfg.causal)
        return reshape(o, B, S, H * hd) @ p["wo"], (k, v)
    qpos = positions[:, None]
    kpos = positions[None, :]
    ok = (kpos - qpos < 1) if cfg.causal else \
        torch.ones((S, S), dtype=torch.bool, device=x.device)
    ok = ok & (qpos - kpos < window) & (kpos - qpos < window)
    scores = _gqa_scores(q, k, cfg)
    scores = torch.where(ok[None, None, None], scores,
                         torch.full((), NEG_INF, device=x.device))
    return _mix(scores, v, cfg) @ p["wo"], (k, v)


def attention_decode(p, cfg, x, cache_k, cache_v, *, window, index):
    """One-token decode. x: (B,1,D); cache_k/v: (B,Smax,KV,hd); index: 0-d
    integer tensor, the token's position.

    Writes the new k/v into the caches at slot `index % Smax`, in place,
    and attends over positions <= index within the sliding window.
    Returns (out, cache_k, cache_v): the caches are the tensors given,
    holding the values of the reference's functional update.
    """
    pos = index.reshape(1)
    q, k1, v1 = _project_qkv(p, cfg, x, pos)
    Smax = cache_k.shape[1]
    # Ring-buffer write: slot = index % Smax. When Smax covers the full
    # sequence this is a plain positional write; when the cache is
    # window-sized (window_kv_cache) old entries are overwritten.
    slot = torch.remainder(pos, Smax).long()
    index_copy_(cache_k, 1, slot, k1.to(cache_k.dtype))
    index_copy_(cache_v, 1, slot, v1.to(cache_v.dtype))
    j = torch.arange(Smax, dtype=index.dtype, device=x.device)
    # true position of slot j; fmod truncates as the reference's lax.rem,
    # so a slot not yet written gets a position above index
    kpos = index - torch.fmod(index - j, Smax)
    ok = (kpos >= 0) & (kpos <= index) & (index - kpos < window)
    scores = _gqa_scores(q, cache_k, cfg)                # (B,KV,G,1,Smax)
    scores = torch.where(ok[None, None, None, None], scores,
                         torch.full((), NEG_INF, device=x.device))
    out = _mix(scores, cache_v, cfg) @ p["wo"]
    return out, cache_k, cache_v
