"""Oracles for every kernel of the port, under the reference's names
(`repro/kernels/ref.py`): naive versions written independently of the
kernels' plain versions where the function is short, the model's own
per-step oracle for the SSD scan."""
from __future__ import annotations

import zlib

import numpy as np
import torch

from repro_torch.models.ssm import ssd_scan_ref as _ssd_scan_ref

NEG_INF = -1e30


def xor_reduce_ref(blocks) -> np.ndarray:
    """blocks: (k, n) uint32 -> (n,) uint32 (numpy, row by row)."""
    blocks = _host_u32(blocks)
    out = blocks[0].copy()
    for i in range(1, blocks.shape[0]):
        out ^= blocks[i]
    return out


def encode_bucket_ref(blocks, nbytes: int):
    """Host oracle for kernels.stage.encode_bucket: numpy XOR fold +
    zlib CRC over the first `nbytes` bytes.  Returns (lanes, crc)."""
    acc = xor_reduce_ref(blocks)
    crc = zlib.crc32(acc.view(np.uint8)[:nbytes]) & 0xFFFFFFFF
    return acc, crc


def ssd_scan_ref(u, a, Bm, Cm, h0=None):
    """Naive SSD recurrence (the model's oracle, `models.ssm.ssd_scan_ref`).

    u: (B,S,H,P) fp32; a: (B,S,H) log-decay; Bm/Cm: (B,S,N).
    Returns (y (B,S,H,P), h_final (B,H,P,N)).
    """
    return _ssd_scan_ref(u, a, Bm, Cm, h0=h0)


def swa_attention_ref(q, k, v, *, window, causal=True):
    """Naive masked softmax attention.

    q: (B,Sq,KV,G,hd), k/v: (B,Sk,KV,hd); window: python int or None
    (full).
    """
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * hd ** -0.5
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (qpos - kpos < window) & (kpos - qpos < window)
    s = torch.where(ok[None, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)


def _host_u32(blocks) -> np.ndarray:
    if isinstance(blocks, torch.Tensor):
        return blocks.detach().view(torch.int32).cpu().numpy().view(np.uint32)
    return np.asarray(blocks, dtype=np.uint32)
