"""The plain forward pass of the benchmarked family (Mamba2), in float32.

The same mathematics as the program's model (and the JAX package it
ports): RMSNorm with the gain applied as 1 + g; Mamba2 layers (one input
projection to z, x, B, C and dt, a causal depthwise convolution with
SiLU, the chunked SSD scan with its D skip, a gated RMSNorm, the output
projection) with a tied head; the mean cross entropy over every token.
Every product is a float32 product (TF32 is switched off by the caller).

`low=True` is the control, the step below the bfloat16 the configuration
trains in: float8 wherever the program holds bfloat16 (every product's
operands and result, the residual stream, the outputs of the norms, of
each term and partial sum of the convolution, of the gates, the
logits), e4m3 forward and e5m2 for the gradients
backward, one scale a tensor; the reductions inside a product, a norm or
the scan stay float32, as the program's do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.weights import ssm_dims


def _q8(t, dtype):
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (t * scale).to(dtype).to(t.dtype) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _q8(x, torch.float8_e4m3fn), _q8(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _q8(g, torch.float8_e5m2)
        gx = gq @ wq.T
        gw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return gx, gw


class _Fp8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _q8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _q8(g, torch.float8_e5m2)


def rnd(t, low: bool):
    """A tensor the program stores in bfloat16: float8 in the control."""
    return _Fp8Round.apply(t) if low else t


def mm(x, w, low: bool):
    return rnd(_Fp8Matmul.apply(x, w), True) if low else x @ w


def rms(x, g, eps: float = 1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + g)


# ------------------------------------------------------------------ Mamba2
def chunk_len(S: int, chunk: int) -> int:
    """The largest divisor of S not above `chunk`."""
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    return Q


def ssd(u, a, Bm, Cm, chunk: int):
    """y_t = sum_{s<=t} (C_t . B_s) exp(a_{s+1} + ... + a_t) u_s, chunked:
    u (B,S,H,P), a (B,S,H), Bm and Cm (B,S,N). A frozen copy of the
    program's plain chunked scan, h0 = 0."""
    B, S, H, P = u.shape
    N = Bm.shape[-1]
    Q = chunk_len(S, chunk)
    nc = S // Q
    uc = u.reshape(B, nc, Q, H, P)
    Bc = Bm.reshape(B, nc, Q, N)
    Cc = Cm.reshape(B, nc, Q, N)
    cum = torch.cumsum(a.reshape(B, nc, Q, H), dim=2)
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=u.device))
    L = torch.exp(torch.where(tri[None, None, :, :, None], rel,
                              torch.full_like(rel, float("-inf"))))
    scores = torch.einsum("bntm,bnsm->bnts", Cc, Bc)
    y = torch.einsum("bntsh,bnshp->bnthp", scores[..., None] * L, uc)
    dec = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bnsm,bnshp->bnhpm", Bc, dec[..., None] * uc)
    decay = torch.exp(cum[:, :, -1, :])
    h = torch.zeros((B, H, P, N), dtype=u.dtype, device=u.device)
    before = []
    for n in range(nc):
        before.append(h)
        h = h * decay[:, n, :, None, None] + states[:, n]
    before = torch.stack(before, 1)
    y = y + torch.einsum("bntm,bnhpm->bnthp", Cc, before) \
        * torch.exp(cum)[..., None]
    return y.reshape(B, S, H, P)


def mamba_layer(c, p, x, low):
    di, H, _ = ssm_dims(c)
    N, P = c["ssm_state"], c["ssm_head_dim"]
    B, S, _ = x.shape
    z, xbc, dt = mm(rnd(rms(x, p["ln1"]), low), p["in_proj"], low).split(
        [di, di + 2 * N, H], -1)
    W = p["conv_w"].shape[0]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    conv = 0
    for i in range(W):
        conv = rnd(conv + rnd(pad[:, i:i + S] * p["conv_w"][i], low), low)
    xbc = rnd(F.silu(rnd(conv + p["conv_b"], low)), low)
    xs, Bm, Cm = xbc.split([di, N, N], -1)
    xs = xs.reshape(B, S, H, P)
    dtp = torch.logaddexp(dt + p["dt_bias"], torch.zeros_like(dt))
    a = dtp * -torch.exp(p["A_log"])
    u = rnd(xs * rnd(dtp, low)[..., None], low)
    y = ssd(u, a, Bm, Cm, c["ssd_chunk"])
    y = rnd((y + p["D_skip"][:, None] * xs).reshape(B, S, di), low)
    y = rnd(rms(rnd(y * rnd(F.silu(z), low), low), p["gate_norm"]), low)
    return rnd(x + mm(y, p["out_proj"], low), low)


# ------------------------------------------------------------------ model
def _layer_params(P: dict, layer: int) -> dict:
    """The layer's slices of the stacked leaves, by short name."""
    return {path[-1]: t[layer] for path, t in P.items()
            if path[:2] == ("blocks", "pos0")}


def nll_sum(c: dict, P: dict, tokens, labels, low: bool = False,
            ce_tokens: int = 4096):
    """Summed cross entropy of rows `tokens` -> `labels` under fp32
    params `P` ({path: tensor}); each layer recomputed in the backward."""
    x = rnd(P[("embed",)][tokens.long()], low)
    for layer in range(c["num_layers"]):
        x = checkpoint(mamba_layer, c, _layer_params(P, layer), x, low,
                       use_reentrant=False)
    x = rnd(rms(x, P[("final_norm",)]), low).reshape(-1, x.shape[-1])
    w_out = P[("lm_head",)] if ("lm_head",) in P else P[("embed",)].T
    labels = labels.reshape(-1).long()
    total = x.new_zeros(())
    for i in range(0, x.shape[0], ce_tokens):
        total = total + checkpoint(_ce_sum, x[i:i + ce_tokens], w_out,
                                   labels[i:i + ce_tokens], low,
                                   use_reentrant=False)
    return total


def _ce_sum(x, w, labels, low):
    return F.cross_entropy(mm(x, w, low), labels, reduction="sum")
