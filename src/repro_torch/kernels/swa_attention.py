"""Sliding-window GQA flash attention: plain version, CUDA forward and
backward kernels.

Replaces the TPU kernel `repro/kernels/swa_attention.py::swa_flash`
(Pallas `_flash_kernel`) with hand-written CUDA kernels for Hopper, built
for sm_90a by `kernels.build`, and adds kernels for its gradient: the JAX
package trains by letting XLA differentiate
`models.flash.flash_attention`, while here `SWAFlash` (a
`torch.autograd.Function`) pairs the forward kernel with them. Two routes,
by the inputs' type:

* bfloat16 (the training path): `csrc/swa_flash_bf16.cu`, every product on
  the tensor cores (wgmma, bf16 operands, fp32 accumulators) with TMA
  tiles through a ring in shared memory; P and dS are rounded to bf16
  before the products that take them, and the backward starts with a
  pre-pass that writes D = rowsum(dO o O) once a row;
* float32: `csrc/swa_flash.cu`, fp32 FMA on the CUDA cores (fp32 on the
  tensor cores would be TF32).

Head widths (`HEAD_DIMS`): 64, 128 and 256 have kernels of their own; 80,
96 and 112 (hubert-xlarge, phi-3-vision, kimi-k2) run the hd-128 kernels
of either route on zero-filled columns past hd (TMA's out-of-bounds fill;
the fp32 loads' own), storing hd columns a row, with the scale hd ** -0.5
of the real width: 128 / hd times the products of a kernel at hd.

Contract (the reference's): q (B,Sq,KV,G,hd), k/v (B,Sk,KV,hd), float32
or bfloat16, all of one type; query head h = kv*G + g; the output is
(B,Sq,KV,G,hd) in q's type. Query position i sees key position j when
(not causal or j <= i) and |i - j| < window; `window=None` is full
attention (`FULL_WINDOW`).

`swa_flash` dispatches on the inputs' device: a CPU tensor runs
`swa_flash_plain` (gradients from torch autograd through it); a CUDA
tensor launches the kernels or raises; any other device raises. The
kernels are also the custom ops `repro_torch::swa_flash_fwd` and
`swa_flash_bwd` (fake impls, FLOP formulas, DTensor sharding rules),
which DTensor and FakeTensor inputs reach (the dry-run, sharded runs).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.plain_grad import plain_grads
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import FULL_WINDOW

# Geometry of the fp32 kernels; each must equal its counterpart in
# csrc/swa_flash.cu.
FP32_COLS = 64                 # score-tile columns: KV (forward, dQ) or
                               # query (dK/dV) positions per tile
FP32_ROWS = 64                 # query rows per forward block (4 * FWD_TY)
FP32_BWD_ROWS = {64: 64, 80: 64, 96: 64, 112: 64, 128: 64,
                 256: 32}      # rows per backward block
# Geometry of the bf16 kernels; each must equal its counterpart in
# csrc/swa_flash_bf16.cu (STAGES, FWD_ROWS, DQ_ROWS, DKDV_COLS, Geo<hd>).
BF16_STAGES = 2                # ring slots of every kernel
BF16_FWD_ROWS = 128            # query rows per forward block
BF16_DQ_ROWS = 128             # query rows per dQ block
BF16_DKDV_COLS = 64            # query rows per dK/dV ring tile
_HD128 = {"fwd_cols": 128, "dq_cols": 64, "dkdv_rows": 128}
BF16_TILES = {                 # by hd: keys per forward and dQ ring tile,
    64: _HD128, 80: _HD128,    # KV rows per dK/dV block
    96: _HD128, 112: _HD128, 128: _HD128,
    256: {"fwd_cols": 64, "dq_cols": 32, "dkdv_rows": 64},
}
HEAD_DIMS = tuple(BF16_TILES)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _window(window) -> int:
    w = FULL_WINDOW if window is None else int(window)
    if w < 1:
        raise ValueError(f"window must be >= 1 (or None), got {window}")
    return w


def swa_flash_plain(q, k, v, *, window, causal=True, with_lse=False):
    """`models.flash.flash_attention` with the model's tiling
    (`models.attention`'s flash branch) and the static band: the port's
    windows are python ints, so the KV blocks outside each query block's
    band are always skipped (the values are those of the full sweep).
    With `with_lse`, also each row's lse (B,KV,G,Sq) float32, as the
    forward kernels write it."""
    w = _window(window)
    Sq, Sk = q.shape[1], k.shape[1]
    return flash_attention(q, k, v, window=w, causal=causal,
                           block_q=max(512, Sq // 16),
                           block_k=max(1024, Sk // 16),
                           band=w if w < FULL_WINDOW else None,
                           with_lse=with_lse)


def band_pairs(Sq, Sk, window, causal) -> int:
    """(query, key) pairs of an Sq x Sk attention that the mask lets
    through: kpos <= qpos if causal, |qpos - kpos| < window: the work the
    kernels' bound counts (`chip_smoke.py` `band_pairs`)."""
    W = min(_window(window), max(Sq, Sk))
    if Sq == Sk:
        S = Sq
        W = min(W, S)
        below = W * (W + 1) // 2 + (S - W) * W   # 0 <= qpos - kpos < W
        return below if causal else 2 * below - S
    pairs = 0
    for i in range(Sq):
        lo = max(0, i - W + 1)
        hi = min(Sk - 1, i if causal else i + W - 1)
        pairs += max(0, hi - lo + 1)
    return pairs


def swa_flops(q_shape, k_shape, window, causal):
    """(forward, backward) FLOP of the kernels on these shapes: 2 products
    of hd a band pair forward (S, PV), 5 backward (S, dP, dV, dQ, dK)."""
    B, Sq, KV, G, hd = q_shape
    pairs = band_pairs(Sq, k_shape[1], window, causal) * B * KV * G
    return 4 * hd * pairs, 10 * hd * pairs


# ------------------------------------------------------------------ checks
def _check(q, k, v) -> None:
    """Types, ranks and shapes (both routes)."""
    for name, t, rank in (("q", q, 5), ("k", k, 4), ("v", v, 4)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != rank:
            raise ValueError(f"{name} must have rank {rank}, got shape "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    B, Sq, KV, G, hd = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) \
            != (B, KV, hd):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be (B, Sk, KV, hd) for q {tuple(q.shape)}")
    if min(B, Sq, KV, G, hd, k.shape[1]) < 1:
        raise ValueError(f"empty attention input: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")


def _check_cuda(*named) -> None:
    """Head width, layout and device the kernels take; no silent copy."""
    hd = named[0][1].shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not among the kernels' {HEAD_DIMS}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (the kernels take "
                             f"row strides from the shapes)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"the swa_flash kernels take CUDA tensors, got "
                             f"{name} on {t.device}")


# ------------------------------------------------------------------ kernels
def _lib(dtype):
    """The fp32 kernels' library or the bf16 kernels', by input type."""
    from repro_torch.kernels.build import library
    if dtype == torch.bfloat16:
        return library("swa_flash_bf16", _BF16_SIGNATURES)
    return library("swa_flash", _SIGNATURES)


def _raise_on(rc: int, what: str, dtype) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_lib(dtype).reft_swa_error_string(rc).decode()}")


def _dims(q, k, window, causal):
    B, Sq, KV, G, hd = q.shape
    return (B, Sq, k.shape[1], KV, G, hd, _window(window), int(bool(causal)),
            ctypes.c_float(hd ** -0.5), _DTYPES[q.dtype],
            q.device.index or 0, torch.cuda.current_stream(q.device)
            .cuda_stream)


def swa_flash_fwd(q, k, v, *, window, causal=True):
    """Forward kernel. -> (o, lse): o (B,Sq,KV,G,hd) in q's type, lse
    (B,KV,G,Sq) float32 = m + log l of each row's online softmax."""
    _check(q, k, v)
    _check_cuda(("q", q), ("k", k), ("v", v))
    B, Sq, KV, G, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    rc = _lib(q.dtype).reft_swa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    o.data_ptr(), lse.data_ptr(),
                                    *_dims(q, k, window, causal))
    _raise_on(rc, "swa_flash_fwd", q.dtype)
    swa_flash_fwd.launches += 1
    return o, lse


swa_flash_fwd.launches = 0     # kernel launches (not plain-version calls)


def swa_flash_bwd(do, q, k, v, o, lse, *, window, causal=True):
    """Backward kernels (bf16: the D pre-pass, dQ, then dK and dV; fp32:
    dQ, then dK and dV; one launch count a call). -> (dq, dk, dv) in the
    inputs' type and shapes."""
    _check(q, k, v)
    B, Sq, KV, G, hd = q.shape
    for name, t, shape, dtype in (("do", do, q.shape, q.dtype),
                                  ("o", o, q.shape, q.dtype),
                                  ("lse", lse, (B, KV, G, Sq),
                                   torch.float32)):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise TypeError(f"{name} must be a {dtype} torch.Tensor")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{tuple(shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    _check_cuda(("q", q), ("k", k), ("v", v), ("do", do), ("o", o),
                ("lse", lse))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ptrs = [do, q, k, v, o, lse, dq, dk, dv]
    if q.dtype == torch.bfloat16:
        # D = rowsum(dO o O), written by the pre-pass, read by both kernels
        ptrs.insert(6, torch.empty((B, KV, G, Sq), dtype=torch.float32,
                                   device=q.device))
    rc = _lib(q.dtype).reft_swa_bwd(*(t.data_ptr() for t in ptrs),
                                    *_dims(q, k, window, causal))
    _raise_on(rc, "swa_flash_bwd", q.dtype)
    swa_flash_bwd.launches += 1
    return dq, dk, dv


swa_flash_bwd.launches = 0     # kernel launches (not plain-version calls)

_P = ctypes.c_void_p
_I = ctypes.c_int
# ..., B, Sq, Sk, KV, G, hd, window, causal, scale, dtype, device, stream
_DIMS = [_I] * 8 + [ctypes.c_float, _I, _I, _P]
_SIGNATURES = {
    "reft_swa_fwd": ([_P] * 5 + _DIMS, _I),        # q, k, v, o, lse
    # do, q, k, v, o, lse, dq, dk, dv
    "reft_swa_bwd": ([_P] * 9 + _DIMS, _I),
    "reft_swa_error_string": ([_I], ctypes.c_char_p),
}
_BF16_SIGNATURES = {
    **_SIGNATURES,
    # do, q, k, v, o, lse, D, dq, dk, dv
    "reft_swa_bwd": ([_P] * 10 + _DIMS, _I),
}


# ------------------------------------------------------------- custom ops
# The kernels as torch.library custom ops: how torch's tracing machinery
# sees them. A DTensor reaches them through the sharding rules below (each
# rank's shard then runs the op's impl); a FakeTensor or meta tensor
# through the fake impls (shapes, no data) and the FLOP formulas. The impl
# is the wrapper's route: the CUDA kernels on a CUDA tensor, the plain
# version (and its autograd) on a CPU tensor, a raise on any other.
def _fwd_impl(q, k, v, window, causal):
    if q.device.type == "cuda":
        return swa_flash_fwd(q, k, v, window=window, causal=causal)
    if q.device.type == "cpu":
        _check(q, k, v)
        o, lse = swa_flash_plain(q, k, v, window=window, causal=causal,
                                 with_lse=True)
        return o.contiguous(), lse.contiguous()
    raise ValueError(f"swa_flash runs on cuda or cpu tensors, not "
                     f"{q.device}")


def _bwd_impl(do, q, k, v, o, lse, window, causal):
    if q.device.type == "cuda":
        return swa_flash_bwd(do, q, k, v, o, lse, window=window,
                             causal=causal)
    if q.device.type == "cpu":
        _check(q, k, v)
        return plain_grads(lambda *t: (swa_flash_plain(
            *t, window=window, causal=causal),), (q, k, v), (do,))
    raise ValueError(f"swa_flash runs on cuda or cpu tensors, not "
                     f"{q.device}")


swa_flash_fwd_op = torch.library.custom_op(
    "repro_torch::swa_flash_fwd", _fwd_impl, mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, int window, bool causal) "
           "-> (Tensor, Tensor)")
swa_flash_bwd_op = torch.library.custom_op(
    "repro_torch::swa_flash_bwd", _bwd_impl, mutates_args=(),
    schema="(Tensor do, Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, "
           "int window, bool causal) -> (Tensor, Tensor, Tensor)")


def workspace_bytes(q, k, window, causal, backward: bool) -> int:
    """Scratch the kernels allocate beyond their outputs: the bf16
    backward's D (B,KV,G,Sq) float32."""
    if backward and q.dtype == torch.bfloat16:
        B, Sq, KV, G, _ = q.shape
        return 4 * B * KV * G * Sq
    return 0


@swa_flash_fwd_op.register_fake
def _fwd_fake(q, k, v, window, causal):
    B, Sq, KV, G, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((B, KV, G, Sq), dtype=torch.float32))


@swa_flash_bwd_op.register_fake
def _bwd_fake(do, q, k, v, o, lse, window, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _register_flops():
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.swa_flash_fwd)
    def _fwd_flops(q, k, v, window, causal, *args, **kwargs):
        return swa_flops(q, k, window, causal)[0]

    @register_flop_formula(torch.ops.repro_torch.swa_flash_bwd)
    def _bwd_flops(do, q, k, v, o, lse, window, causal, *args, **kwargs):
        return swa_flops(q, k, window, causal)[1]


def _register_sharding():
    """Attention is independent over batch rows, KV heads and the query
    heads of a group: each is a way to shard it with no communication."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    R = Replicate()

    @register_sharding(torch.ops.repro_torch.swa_flash_fwd.default)
    def _fwd_rule(q, k, v, window, causal):
        # (o, lse) <- (q, k, v, window, causal)
        return [([R, R], [R, R, R, None, None]),
                ([Shard(0), Shard(0)],
                 [Shard(0), Shard(0), Shard(0), None, None]),
                ([Shard(2), Shard(1)],
                 [Shard(2), Shard(2), Shard(2), None, None]),
                ([Shard(3), Shard(2)], [Shard(3), R, R, None, None])]

    @register_sharding(torch.ops.repro_torch.swa_flash_bwd.default)
    def _bwd_rule(do, q, k, v, o, lse, window, causal):
        # (dq, dk, dv) <- (do, q, k, v, o, lse, window, causal)
        s0, s2, s3 = Shard(0), Shard(2), Shard(3)
        return [([R, R, R], [R, R, R, R, R, R, None, None]),
                ([s0, s0, s0], [s0, s0, s0, s0, s0, s0, None, None]),
                ([s2, s2, s2], [s2, s2, s2, s2, s2, Shard(1), None, None]),
                ([s3, Partial(), Partial()],
                 [s3, s3, R, R, s3, s2, None, None])]


_register_flops()
_register_sharding()


def _traced(t) -> bool:
    """A tensor subclass (DTensor, FakeTensor): reach the kernels through
    their custom ops. A plain tensor calls the wrappers directly."""
    return type(t) is not torch.Tensor


class SWAFlash(torch.autograd.Function):
    """Forward kernel, backward kernels. Works under non-reentrant
    `torch.utils.checkpoint`: the forward runs again during backward and
    saves the same tensors. DTensor and FakeTensor inputs go through the
    custom ops."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal):
        if _traced(q):
            o, lse = swa_flash_fwd_op(q, k, v, window, causal)
        else:
            o, lse = swa_flash_fwd(q, k, v, window=window, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.causal = window, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if _traced(q):
            dq, dk, dv = swa_flash_bwd_op(do.contiguous(), q, k, v, o, lse,
                                          ctx.window, ctx.causal)
        else:
            dq, dk, dv = swa_flash_bwd(do.contiguous(), q, k, v, o, lse,
                                       window=ctx.window, causal=ctx.causal)
        return dq, dk, dv, None, None


def swa_flash(q, k, v, *, window, causal=True):
    """The attention core of a flash-path layer: (B,Sq,KV,G,hd) in q's
    type. Differentiable on both routes: CPU tensors run `swa_flash_plain`
    under torch autograd, CUDA tensors the kernels of `SWAFlash`; there is
    no fallback from one to the other. A DTensor or FakeTensor (either
    device) goes through `SWAFlash` and the custom ops."""
    _check(q, k, v)
    w = _window(window)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"swa_flash runs on cuda or cpu tensors, not "
                         f"{q.device}")
    if _traced(q):
        return SWAFlash.apply(q, k, v, w, bool(causal))
    if q.device.type == "cpu":
        return swa_flash_plain(q, k, v, window=w, causal=causal)
    _check_cuda(("q", q), ("k", k), ("v", v))
    return SWAFlash.apply(q, k, v, w, bool(causal))
