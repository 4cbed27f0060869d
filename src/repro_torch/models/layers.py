"""Shared neural-net primitives (plain PyTorch ops on dicts of tensors).

The counterpart of `repro/models/layers.py`: the same math and the same
parameter shapes.  Initial values come from a `torch.Generator`, so they
differ from JAX's; tests carry JAX-initialised weights across with
`repro_torch.convert`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.spans import span
from repro_torch.core.treebytes import torch_dtype
from repro_torch.dist.api import vocab_nll

# Sentinel window width meaning "full attention" (fits int32, > any seq len).
FULL_WINDOW = 1 << 30


def dtype_of(cfg) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def pdtype_of(cfg) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


def rms_norm(x, gain, eps: float = 1e-6):
    with span("model.rms_norm"):
        dt = x.dtype
        x = x.float()
        var = x.square().mean(-1, keepdim=True)
        out = x * torch.rsqrt(var + eps)
        return (out * (1.0 + gain.float())).to(dt)


def init_rms(d, dtype, device):
    return torch.zeros((d,), dtype=dtype, device=device)   # gain as (1 + g)


def dense_init(gen, shape, dtype, device, scale=None):
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = fan_in ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------- RoPE
def rope_angles(positions, head_dim, theta):
    """positions: (...,) int -> cos/sin of shape (..., head_dim//2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, hd); cos/sin: (S, hd//2) or (B, S, hd//2)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:                      # (S, half) -> broadcast over B, H
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:                                   # (B, S, half)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    xf = x.float()
    x1f, x2f = xf[..., :half], xf[..., half:]
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- MLP
def init_mlp(gen, cfg, device):
    D, Fd = cfg.d_model, cfg.d_ff
    pd = pdtype_of(cfg)
    return {
        "wi_gate": dense_init(gen, (D, Fd), pd, device),
        "wi_up": dense_init(gen, (D, Fd), pd, device),
        "wo": dense_init(gen, (Fd, D), pd, device),
    }


def mlp(p, x):
    h = F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    return h @ p["wo"]


def cross_entropy(logits, labels, mask=None):
    """Mean CE in fp32. logits (..., V), labels (...) integer."""
    nll = vocab_nll(logits, labels)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def chunked_cross_entropy(h, w_out, labels, chunk, mask=None):
    """CE over sequence chunks without materializing (B, S, V).

    h: (B, S, D) final hidden states; w_out: (D, V); labels: (B, S).
    """
    B, S, D = h.shape
    n = max(1, S // chunk)
    while S % n:
        n -= 1
    c = S // n
    tot = h.new_zeros((), dtype=torch.float32)
    cnt = h.new_zeros((), dtype=torch.float32)
    for i in range(n):
        hh = h[:, i * c:(i + 1) * c]
        ll = labels[:, i * c:(i + 1) * c]
        mm = (mask[:, i * c:(i + 1) * c].float() if mask is not None
              else torch.ones(ll.shape, dtype=torch.float32, device=h.device))
        nll = vocab_nll(hh @ w_out, ll)
        tot = tot + (nll * mm).sum()
        cnt = cnt + mm.sum()
    return tot / torch.clamp(cnt, min=1.0)
