"""Mamba2 (SSD, state-space duality) block.

The counterpart of `repro/models/ssm.py`: the same parameters, casts and
math. Training and prefill run the SSD core `kernels.ssd_scan.ssd_scan`,
whose route the inputs' device decides (the plain chunked scan on the
CPU, the CUDA kernels on the card); decode (`ssm_decode`) takes the
O(1)-state recurrent step in plain PyTorch, as the reference's plain
`jnp`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.spans import span
from repro_torch.dist.api import P, reshape, shard, split, zero_pad
from repro_torch.kernels.ssd_scan import DEFAULT_CHUNK, ssd_scan
from repro_torch.models.layers import dense_init, init_rms, pdtype_of, rms_norm


def init_ssm(gen, cfg, device):
    D, di, N, H, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_conv_width)
    pd = pdtype_of(cfg)
    ch = di + 2 * N
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, (D, 2 * di + 2 * N + H), pd, device),
        "conv_w": dense_init(gen, (W, ch), pd, device, scale=W ** -0.5),
        "conv_b": torch.zeros((ch,), dtype=pd, device=device),
        "A_log": torch.zeros((H,), **f32),                # A = -exp(A_log) = -1
        "dt_bias": torch.full((H,), 0.5, **f32),
        "D_skip": torch.ones((H,), **f32),
        "gate_norm": init_rms(di, pd, device),
        "out_proj": dense_init(gen, (di, D), pd, device),
    }


def _split_proj(p, cfg, x):
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    # the row-parallel projection's sums reduced, rows kept on the batch
    # axes (no op outside a mesh): DTensor would otherwise scatter them
    # over the sequence, which the later matmuls cannot carry
    with span("ssm.proj"):
        proj = shard(x @ p["in_proj"],
                     P(("pod", "data"), *((None,) * (x.dim() - 1))))
    z, xbc, dt = split(proj, [di, di + 2 * N, H], dim=-1)
    return z, xbc, dt                                    # dt: (..., H)


def _conv_full(p, xbc):
    """Causal depthwise conv over the sequence. xbc: (B, S, ch)."""
    with span("ssm.conv"):
        W = p["conv_w"].shape[0]
        pad = zero_pad(xbc, (0, 0, W - 1, 0))
        out = sum(pad[:, i:i + xbc.shape[1], :] * p["conv_w"][i]
                  for i in range(W))
        return F.silu(out + p["conv_b"])


def _conv_step(p, xbc1, conv_state):
    """xbc1: (B, ch) current input; conv_state: (B, W-1, ch).
    -> (silu(conv), the new state (B, W-1, ch), a view of the window)."""
    window = torch.cat([conv_state, xbc1[:, None, :]], dim=1)   # (B,W,ch)
    out = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
    return F.silu(out), window[:, 1:, :]


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))      # jax.nn.softplus


def _gates(p, cfg, dt, xs):
    """dt (B,S,H) raw -> (a, u): log-decay and scaled input."""
    A = -torch.exp(p["A_log"])                           # (H,) negative
    dtp = _softplus(dt.float() + p["dt_bias"])
    a = dtp * A                                          # (B,S,H) <= 0
    u = xs * dtp[..., None].to(xs.dtype)                 # (B,S,H,P)
    return a, u


def ssd_scan_ref(u, a, Bm, Cm, h0=None):
    """Naive per-step recurrence (the reference's oracle; tests only)."""
    B, S, H, P = u.shape
    N = Bm.shape[-1]
    h = torch.zeros((B, H, P, N), dtype=u.dtype, device=u.device) \
        if h0 is None else h0
    ys = []
    for t in range(S):
        h = h * torch.exp(a[:, t])[:, :, None, None] \
            + torch.einsum("bhp,bm->bhpm", u[:, t], Bm[:, t])
        ys.append(torch.einsum("bhpm,bm->bhp", h, Cm[:, t]))
    return torch.stack(ys, 1), h


def ssm_block(p, cfg, x, h0=None, chunk=DEFAULT_CHUNK):
    """Full-sequence mamba2 block. x: (B,S,D) -> (y, (conv_state, h_final)).

    The reference's `use_kernel` flag is gone: `ssd_scan` launches the
    CUDA kernels for tensors on the card and runs its plain version for
    tensors on the CPU. Spans: `ssm.glue` around the block, and inside
    it `ssm.proj`, `ssm.conv`, `ssm.scan` (the SSD core alone) and the
    gated norm's `model.rms_norm`."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    B, S, D = x.shape
    with span("ssm.glue"):
        z, xbc, dt = _split_proj(p, cfg, x)
        conv_state = xbc[:, -(cfg.ssm_conv_width - 1):, :]   # decode handoff
        xbc = _conv_full(p, xbc)
        xs, Bm, Cm = split(xbc, [di, N, N], dim=-1)
        xs = reshape(xs, B, S, H, P)
        a, u = _gates(p, cfg, dt, xs)
        f32 = lambda t: t.to(torch.float32).contiguous()     # noqa: E731
        scan_in = [f32(t) for t in (u, a, Bm, Cm)]
        with span("ssm.scan"):
            y, h_final = ssd_scan(*scan_in, h0=h0, chunk=chunk)
        del scan_in
        y = y + p["D_skip"][None, None, :, None] * xs.float()
        y = reshape(y, B, S, di).to(x.dtype)
        y = rms_norm(y * F.silu(z), p["gate_norm"])
        with span("ssm.proj"):
            out = y @ p["out_proj"]
        return out, (conv_state.to(x.dtype), h_final)


def ssm_decode(p, cfg, x, conv_state, h):
    """One-token step. x: (B,1,D); conv_state: (B,W-1,ch); h: (B,H,P,N)
    float32. Writes the new conv state and h into the tensors given, in
    place (the reference's functional update, value for value), and
    returns (out (B,1,D), conv_state, h)."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    B = x.shape[0]
    z, xbc, dt = _split_proj(p, cfg, x[:, 0, :])
    xbc, new_conv = _conv_step(p, xbc, conv_state)
    conv_state.copy_(new_conv)
    xs, Bm, Cm = split(xbc, [di, N, N], dim=-1)
    xs = reshape(xs, B, H, P)
    A = -torch.exp(p["A_log"])
    dtp = _softplus(dt.float() + p["dt_bias"])                    # (B,H)
    decay = torch.exp(dtp * A)                                    # (B,H)
    u = xs.float() * dtp[..., None]
    h.mul_(decay[:, :, None, None]).addcmul_(u[..., None],
                                             Bm.float()[:, None, None, :])
    y = torch.einsum("bhpm,bm->bhp", h, Cm.float())
    y = y + p["D_skip"][None, :, None] * xs.float()
    y = reshape(y, B, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"])
    return (y @ p["out_proj"])[:, None, :], conv_state, h
