"""Flash-style (online-softmax) attention in plain PyTorch ops.

The counterpart of `repro/models/flash.py` (plain jnp there, not a Pallas
kernel): long sequences never materialize the (Sq, Sk) score matrix — live
memory per step is one (bq, bk) tile.  Supports causal masking, windows,
GQA and the reference's banded mode: with a static `band`, the KV blocks
wholly outside each query block's window are skipped, which turns O(S^2)
work into O(S*W) and leaves the values as they are.

This is the plain version of the `swa_flash` CUDA kernels
(`kernels/swa_attention.py`), as the reference's is the semantics of its
`swa_attention` Pallas kernel.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _pick_block(n, target):
    b = min(target, n)
    while n % b:
        b -= 1
    return b


def _band_blocks(iq, bq, bk, nk, band, causal):
    """KV block indices of query block `iq` that meet the static band."""
    if band is None:
        return range(nk)
    q_lo = iq * bq
    q_hi = q_lo + bq - 1
    lo = max(0, (q_lo - band + 1) // bk)
    hi = min(nk - 1, q_hi // bk if causal else (q_hi + band - 1) // bk)
    return range(lo, hi + 1)


def flash_attention(q, k, v, *, window, causal=True, block_q=512,
                    block_k=1024, band=None, with_lse=False):
    """q: (B,Sq,KV,G,hd), k/v: (B,Sk,KV,hd); window: int.

    band: optional static int window; KV blocks wholly outside the band of
    each query block are skipped (exact banded attention).
    Returns (B,Sq,KV,G,hd) in q.dtype; with `with_lse`, also each row's
    log-sum-exp m + log l of its scaled scores, (B,KV,G,Sq) float32, as
    the kernels write it.
    """
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    bq = _pick_block(Sq, block_q)
    bk = _pick_block(Sk, block_k)
    nq, nk = Sq // bq, Sk // bk
    scale = hd ** -0.5
    dev = q.device
    neg = torch.full((), NEG_INF, device=dev)

    outs, lses = [], []
    for iq in range(nq):
        q_i = q[:, iq * bq:(iq + 1) * bq].float()
        qpos = iq * bq + torch.arange(bq, device=dev)
        m = torch.full((B, KV, G, bq), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, bq), device=dev)
        acc = torch.zeros((B, KV, G, bq, hd), device=dev)
        for ik in _band_blocks(iq, bq, bk, nk, band, causal):
            k_i = k[:, ik * bk:(ik + 1) * bk]
            v_i = v[:, ik * bk:(ik + 1) * bk]
            kpos = ik * bk + torch.arange(bk, device=dev)
            s = torch.einsum("bqkgh,bskh->bkgqs", q_i, k_i.float()) * scale
            ok = torch.ones((bq, bk), dtype=torch.bool, device=dev)
            if causal:
                ok = ok & (kpos[None, :] <= qpos[:, None])
            ok = ok & (qpos[:, None] - kpos[None, :] < window)
            ok = ok & (kpos[None, :] - qpos[:, None] < window)
            s = torch.where(ok[None, None, None], s, neg)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(v_i.dtype), v_i)
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.to(q.dtype))                     # (B,KV,G,bq,hd)
        if with_lse:
            lses.append(m + torch.log(l))
    o = torch.stack(outs, dim=1)                          # (B,nq,KV,G,bq,hd)
    o = o.permute(0, 1, 4, 2, 3, 5)                       # (B,nq,bq,KV,G,hd)
    o = o.reshape(B, Sq, KV, G, hd)
    if with_lse:
        return o, torch.cat(lses, dim=-1)
    return o
