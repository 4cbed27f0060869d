"""Mamba2 SSD scan: plain version, CUDA forward and backward kernels.

Replaces the TPU kernel `repro/kernels/ssd_scan.py::ssd_scan` (Pallas
`_ssd_kernel`) with hand-written CUDA kernels for Hopper
(`csrc/ssd_scan.cu`, built for sm_90a by `kernels.build`), and adds
kernels for its gradient: the JAX package trains by letting XLA
differentiate `models.ssm.ssd_chunked`, while here `SSDScan` (a
`torch.autograd.Function`) pairs the two wrappers.

Contract (the reference's, `ssd_chunked`): u (B,S,H,P) fp32, a (B,S,H)
fp32 log-decay <= 0, Bm/Cm (B,S,N) fp32, h0 (B,H,P,N) or None ->
y (B,S,H,P), h_final (B,H,P,N), with the recurrence

    h_t = e^{a_t} h_{t-1} + u_t (x) b_t,    y_t[p] = sum_n h_t[p, n] c_t[n].

The kernels compute it in its chunked (state-space-duality) form, the
chunks in parallel and every product on the tensor cores: chunk states, a
short state passing over the nc = S / Q chunks, and the chunk scan; the
backward runs the same passes in reverse (the source's header note has
the algebra). Each product is bf16 mma.sync with every fp32 operand split
into bf16 hi + lo (hi*hi + hi*lo + lo*hi: about 2^-17 relative a term),
which holds the fp32 contract. What bounds the kernels is their staging:
each 64 x 64 operand tile is split and written to shared memory by one
register pass, then multiplied; there is no pipeline yet.

`ssd_scan` dispatches on the inputs' device: a CPU tensor runs
`ssd_scan_plain` (gradients from torch autograd through it); a CUDA tensor
launches the kernels or raises; any other device raises. The kernels are
also the custom ops `repro_torch::ssd_scan_fwd` and `ssd_scan_bwd` (fake
impls, FLOP formulas, DTensor sharding rules), which DTensor and
FakeTensor inputs reach (the dry-run, sharded runs).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.plain_grad import plain_grads

DEFAULT_CHUNK = 256
# Kernel geometry; each must equal the #define of the same name in
# csrc/ssd_scan.cu.
TILE = 64          # rows of an output tile and depth of a staged k-chunk
THREADS = 128      # threads a block: 4 warps of 16 output rows each
MAX_Q = 4096       # longest chunk: the backward keeps a chunk's dcum in
                   # shared memory


def chunk_len(S: int, chunk: int) -> int:
    """Chunk length Q as the reference picks it: the largest divisor of S
    not above `chunk`."""
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    return Q


def ssd_scan_plain(u, a, Bm, Cm, h0=None, *, chunk: int = DEFAULT_CHUNK):
    """The chunked SSD of `repro/models/ssm.py::ssd_chunked`, in torch.

    One change from the reference: the intra-chunk decay masks the upper
    triangle BEFORE the exponential (exp(-inf) = 0), where the reference
    takes exp of every entry and masks after. The values are the same;
    the reference's gradient is NaN once some exp overflows there
    (cum[t] - cum[s] > 88 for s > t), since its where-backward multiplies
    a zero cotangent by inf. Here it stays finite."""
    y, h, _ = _ssd_plain_states(u, a, Bm, Cm, h0, chunk=chunk)
    return y, h


def _ssd_plain_states(u, a, Bm, Cm, h0=None, *, chunk: int):
    """`ssd_scan_plain`, also returning hs (B,H,nc,P,N): the state before
    each chunk, as the forward kernels write it."""
    B, S, H, P = u.shape
    N = Bm.shape[-1]
    Q = chunk_len(S, chunk)
    nc = S // Q
    uc = u.reshape(B, nc, Q, H, P)
    ac = a.reshape(B, nc, Q, H)
    Bc = Bm.reshape(B, nc, Q, N)
    Cc = Cm.reshape(B, nc, Q, N)

    cum = torch.cumsum(ac, dim=2)                          # (B,nc,Q,H)
    # intra-chunk: L[t,s] = exp(cum[t]-cum[s]) for s<=t
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=u.device))
    L = torch.exp(torch.where(tri[None, None, :, :, None], rel,
                              torch.full_like(rel, float("-inf"))))
    scores = torch.einsum("bntm,bnsm->bnts", Cc, Bc)
    y_intra = torch.einsum("bntsh,bnshp->bnthp", scores[..., None] * L, uc)

    # chunk states: S_n = sum_s exp(cum[-1]-cum[s]) B[s] (x) u[s]
    dec = torch.exp(cum[:, :, -1:, :] - cum)               # (B,nc,Q,H)
    states = torch.einsum("bnsm,bnshp->bnhpm", Bc, dec[..., None] * uc)

    # inter-chunk recurrence over nc
    h = torch.zeros((B, H, P, N), dtype=u.dtype, device=u.device) \
        if h0 is None else h0
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (B,nc,H)
    h_prevs = []
    for n in range(nc):
        h_prevs.append(h)                                  # state BEFORE chunk
        h = h * chunk_decay[:, n, :, None, None] + states[:, n]
    h_prevs = torch.stack(h_prevs, 1)                      # (B,nc,H,P,N)

    y_inter = torch.einsum("bntm,bnhpm->bnthp", Cc, h_prevs) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y, h, h_prevs.transpose(1, 2)


# ------------------------------------------------------------------ checks
def _check(u, a, Bm, Cm, h0=None) -> None:
    """Types, ranks, shapes and layout the kernels take (the plain version
    is held to the same contract)."""
    named = [("u", u, 4), ("a", a, 3), ("Bm", Bm, 3), ("Cm", Cm, 3)]
    if h0 is not None:
        named.append(("h0", h0, 4))
    for name, t, rank in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype} "
                            f"(ssm_block casts before the call)")
        if t.dim() != rank:
            raise ValueError(f"{name} must have rank {rank}, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
    B, S, H, P = u.shape
    N = Bm.shape[-1]
    want = {"a": (B, S, H), "Bm": (B, S, N), "Cm": (B, S, N),
            "h0": (B, H, P, N)}
    for name, t, _ in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{want[name]} for u {tuple(u.shape)}")
    if min(B, S, H, P, N) < 1:
        raise ValueError(f"empty SSD input: u {tuple(u.shape)}, N={N}")


def _check_cuda(u) -> None:
    if u.device.type != "cuda":
        raise ValueError(f"the SSD kernels take CUDA tensors, got u on "
                         f"{u.device}")


# ------------------------------------------------------------------ kernels
def _geometry(u, Bm, chunk: int):
    B, S, H, P = u.shape
    N = Bm.shape[-1]
    Q = chunk_len(S, chunk)
    if Q > MAX_Q:
        raise ValueError(f"chunk length Q={Q} above the kernels' {MAX_Q}")
    return B, S, H, P, N, Q, S // Q


def _lib():
    from repro_torch.kernels.build import library
    return library("ssd_scan", _SIGNATURES)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_lib().reft_ssd_error_string(rc).decode()}")


def ssd_scan_fwd(u, a, Bm, Cm, h0=None, *, chunk: int):
    """Forward kernels. -> (y, h_final, hs): hs (B,H,nc,P,N) holds the
    state before each chunk of Q steps, what the backward starts from.
    Four kernels, in order: chunk states (written into hs), the state
    passing (in place over hs), S = C B^T per chunk, the chunk scan.
    Scratch: cum (B,S,H) and S (B,nc,Q,Q)."""
    _check(u, a, Bm, Cm, h0)
    B, S, H, P, N, Q, nc = _geometry(u, Bm, chunk)
    _check_cuda(u)
    dev = u.device
    y = torch.empty_like(u)
    h_final = torch.empty((B, H, P, N), dtype=u.dtype, device=dev)
    hs = torch.empty((B, H, nc, P, N), dtype=u.dtype, device=dev)
    cum = torch.empty((B, S, H), dtype=u.dtype, device=dev)
    Sm = torch.empty((B, nc, Q, Q), dtype=u.dtype, device=dev)
    rc = _lib().reft_ssd_fwd(
        u.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_final.data_ptr(), hs.data_ptr(), cum.data_ptr(), Sm.data_ptr(),
        B, S, H, P, N, Q, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "ssd_scan_fwd")
    ssd_scan_fwd.launches += 1
    return y, h_final, hs


ssd_scan_fwd.launches = 0      # wrapper calls that launched the kernels


def ssd_scan_bwd(dy, dh_final, u, a, Bm, Cm, hs, *, chunk: int):
    """Backward kernels from dh_final (None: zero) and the forward's `hs`.
    -> (du, da, dBm, dCm, dh0) in the forward's layouts. Five kernels:
    X = (e^cum dy)^T C per chunk (into gs), the reverse state passing (gs
    becomes the cotangent of the state after each chunk, and dh0), S and
    the head-summed dS per tile of each chunk with the per-head row and
    column sums dw of dG o S o L, du and da per (chunk, head), dB and dC.
    Scratch: cum (B,S,H), gs (B,H,nc,P,N), S and dS (B,nc,Q,Q), dw
    (B,nc,H,nt,Q) with nt = ceil(Q / TILE); every sum over heads runs
    inside one block, in order."""
    _check(u, a, Bm, Cm)
    B, S, H, P, N, Q, nc = _geometry(u, Bm, chunk)
    for name, t, shape in (("dy", dy, (B, S, H, P)),
                           ("dh_final", dh_final, (B, H, P, N)),
                           ("hs", hs, (B, H, nc, P, N))):
        if t is None and name == "dh_final":
            continue
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 torch.Tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
    _check_cuda(u)
    nt = -(-Q // TILE)
    dev = u.device
    f32 = dict(dtype=u.dtype, device=dev)
    du = torch.empty_like(u)
    da = torch.empty((B, S, H), **f32)
    dBm = torch.empty((B, S, N), **f32)
    dCm = torch.empty((B, S, N), **f32)
    dh0 = torch.empty((B, H, P, N), **f32)
    cum = torch.empty((B, S, H), **f32)
    gs = torch.empty((B, H, nc, P, N), **f32)
    Sm = torch.empty((B, nc, Q, Q), **f32)
    dSm = torch.empty((B, nc, Q, Q), **f32)
    dw = torch.empty((B, nc, H, nt, Q), **f32)
    rc = _lib().reft_ssd_bwd(
        dy.data_ptr(), None if dh_final is None else dh_final.data_ptr(),
        u.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        hs.data_ptr(), du.data_ptr(), da.data_ptr(), dBm.data_ptr(),
        dCm.data_ptr(), dh0.data_ptr(), cum.data_ptr(), gs.data_ptr(),
        Sm.data_ptr(), dSm.data_ptr(), dw.data_ptr(), B, S, H, P, N, Q,
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return du, da, dBm, dCm, dh0


ssd_scan_bwd.launches = 0      # wrapper calls that launched the kernels

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # u, a, Bm, Cm, h0, y, h_final, hs, cum, S, B, S, H, P, N, Q, device,
    # stream
    "reft_ssd_fwd": ([_P] * 10 + [_I] * 7 + [_P], _I),
    # dy, dh_final, u, a, Bm, Cm, hs, du, da, dB, dC, dh0, cum, gs, S, dS,
    # dw, B, S, H, P, N, Q, device, stream
    "reft_ssd_bwd": ([_P] * 17 + [_I] * 7 + [_P], _I),
    "reft_ssd_error_string": ([_I], ctypes.c_char_p),
}


# ------------------------------------------------------------- custom ops
# The kernels as torch.library custom ops: how torch's tracing machinery
# sees them. A DTensor reaches them through the sharding rules below (each
# rank's shard then runs the op's impl); a FakeTensor or meta tensor
# through the fake impls (shapes, no data) and the FLOP formulas. The impl
# is the wrapper's route: the CUDA kernels on a CUDA tensor, the plain
# version (and its autograd) on a CPU tensor, a raise on any other.
def _not_here(u):
    return ValueError(f"ssd_scan runs on cuda or cpu tensors, not "
                      f"{u.device}")


def _fwd_impl(u, a, Bm, Cm, h0, chunk):
    if u.device.type == "cuda":
        return ssd_scan_fwd(u, a, Bm, Cm, h0, chunk=chunk)
    if u.device.type == "cpu":
        _check(u, a, Bm, Cm, h0)
        # the kernels' layouts: contiguous outputs
        return tuple(t.contiguous() for t in
                     _ssd_plain_states(u, a, Bm, Cm, h0, chunk=chunk))
    raise _not_here(u)


def _bwd_impl(dy, dh_final, u, a, Bm, Cm, hs, chunk):
    if u.device.type == "cuda":
        return ssd_scan_bwd(dy, dh_final, u, a, Bm, Cm, hs, chunk=chunk)
    if u.device.type == "cpu":
        _check(u, a, Bm, Cm)
        # from the state before the first chunk (zeros when h0 was None)
        h0 = hs[:, :, 0]
        dh = torch.zeros_like(h0) if dh_final is None else dh_final
        return plain_grads(lambda *t: ssd_scan_plain(*t, chunk=chunk),
                           (u, a, Bm, Cm, h0), (dy, dh))
    raise _not_here(u)


ssd_scan_fwd_op = torch.library.custom_op(
    "repro_torch::ssd_scan_fwd", _fwd_impl, mutates_args=(),
    schema="(Tensor u, Tensor a, Tensor Bm, Tensor Cm, Tensor? h0, "
           "int chunk) -> (Tensor, Tensor, Tensor)")
ssd_scan_bwd_op = torch.library.custom_op(
    "repro_torch::ssd_scan_bwd", _bwd_impl, mutates_args=(),
    schema="(Tensor dy, Tensor? dh_final, Tensor u, Tensor a, Tensor Bm, "
           "Tensor Cm, Tensor hs, int chunk) "
           "-> (Tensor, Tensor, Tensor, Tensor, Tensor)")


def ssd_flops(B, S, H, P, N, Q):
    """(forward, backward) FLOP of the products the chunked kernels do,
    one bf16 term each (the split does three): the causal products count
    the Q (Q + 1) / 2 pairs of a chunk's lower triangle (`chip_smoke.py`
    `ssd_flops`, the bound's work)."""
    nc, tri = S // Q, Q * (Q + 1) // 2
    state = nc * H * 2 * P * N * Q          # st, X, du_state, D, dC/dB heads
    causal = nc * H * 2 * P * tri           # (S o L) u, dy u^T, (S o L)^T dy
    cb = nc * 2 * N * tri                   # C B^T, dS B, dS^T C
    return (B * (2 * state + causal + cb),
            B * (5 * state + 2 * causal + 3 * cb))


def _flops_of(u_shape, Bm_shape, chunk):
    B, S, H, P = u_shape
    return ssd_flops(B, S, H, P, Bm_shape[-1], chunk_len(S, chunk))


def workspace_bytes(u, Bm, chunk, backward: bool) -> int:
    """Scratch the kernels allocate beyond their outputs (fp32): forward
    cum (B,S,H) and S (B,nc,Q,Q); backward cum, gs (B,H,nc,P,N), S and dS,
    dw (B,nc,H,nt,Q)."""
    B, S, H, P = u.shape
    N = Bm.shape[-1]
    Q = chunk_len(S, chunk)
    nc = S // Q
    cum, sq = B * S * H, B * nc * Q * Q
    if not backward:
        return 4 * (cum + sq)
    nt = -(-Q // TILE)
    return 4 * (cum + B * H * nc * P * N + 2 * sq + B * nc * H * nt * Q)


@ssd_scan_fwd_op.register_fake
def _fwd_fake(u, a, Bm, Cm, h0, chunk):
    B, S, H, P = u.shape
    N = Bm.shape[-1]
    nc = S // chunk_len(S, chunk)
    return (torch.empty_like(u), u.new_empty((B, H, P, N)),
            u.new_empty((B, H, nc, P, N)))


@ssd_scan_bwd_op.register_fake
def _bwd_fake(dy, dh_final, u, a, Bm, Cm, hs, chunk):
    B, S, H, P = u.shape
    N = Bm.shape[-1]
    return (torch.empty_like(u), torch.empty_like(a), torch.empty_like(Bm),
            torch.empty_like(Cm), u.new_empty((B, H, P, N)))


def _register_flops():
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.ssd_scan_fwd)
    def _fwd_flops(u, a, Bm, Cm, h0, chunk, *args, **kwargs):
        return _flops_of(u, Bm, chunk)[0]

    @register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
    def _bwd_flops(dy, dh_final, u, a, Bm, Cm, hs, chunk, *args, **kwargs):
        return _flops_of(u, Bm, chunk)[1]


def _register_sharding():
    """The scan is independent over batch rows and over heads (B and C
    are shared by the heads: replicated, and their gradients partial
    sums over the heads' shards)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    R, s0, s1, s2 = Replicate(), Shard(0), Shard(1), Shard(2)

    @register_sharding(torch.ops.repro_torch.ssd_scan_fwd.default)
    def _fwd_rule(u, a, Bm, Cm, h0, chunk):
        # (y, h_final, hs) <- (u, a, Bm, Cm, h0, chunk)
        def h(p):
            return None if h0 is None else p
        return [([R, R, R], [R, R, R, R, h(R), None]),
                ([s0, s0, s0], [s0, s0, s0, s0, h(s0), None]),
                ([s2, s1, s1], [s2, s2, R, R, h(s1), None])]

    @register_sharding(torch.ops.repro_torch.ssd_scan_bwd.default)
    def _bwd_rule(dy, dh_final, u, a, Bm, Cm, hs, chunk):
        # (du, da, dBm, dCm, dh0) <- (dy, dh_final, u, a, Bm, Cm, hs, chunk)
        def d(p):
            return None if dh_final is None else p
        return [([R, R, R, R, R], [R, d(R), R, R, R, R, R, None]),
                ([s0, s0, s0, s0, s0], [s0, d(s0), s0, s0, s0, s0, s0, None]),
                ([s2, s2, Partial(), Partial(), s1],
                 [s2, d(s1), s2, s2, R, R, s1, None])]


_register_flops()
_register_sharding()


def _traced(t) -> bool:
    """A tensor subclass (DTensor, FakeTensor): reach the kernels through
    their custom ops. A plain tensor calls the wrappers directly."""
    return type(t) is not torch.Tensor


class SSDScan(torch.autograd.Function):
    """Forward kernel, backward kernel. Works under non-reentrant
    `torch.utils.checkpoint`: the forward runs again during backward and
    saves the same tensors. DTensor and FakeTensor inputs go through the
    custom ops."""

    @staticmethod
    def forward(ctx, u, a, Bm, Cm, h0, chunk):
        if _traced(u):
            y, h_final, hs = ssd_scan_fwd_op(u, a, Bm, Cm, h0, chunk)
        else:
            y, h_final, hs = ssd_scan_fwd(u, a, Bm, Cm, h0, chunk=chunk)
        ctx.save_for_backward(u, a, Bm, Cm, hs)
        ctx.chunk = chunk
        ctx.has_h0 = h0 is not None
        ctx.set_materialize_grads(False)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        u, a, Bm, Cm, hs = ctx.saved_tensors
        dy = torch.zeros_like(u) if dy is None else dy.contiguous()
        if dh_final is not None:
            dh_final = dh_final.contiguous()
        if _traced(u):
            du, da, dB, dC, dh0 = ssd_scan_bwd_op(dy, dh_final, u, a, Bm, Cm,
                                                  hs, ctx.chunk)
        else:
            du, da, dB, dC, dh0 = ssd_scan_bwd(dy, dh_final, u, a, Bm, Cm,
                                               hs, chunk=ctx.chunk)
        return du, da, dB, dC, (dh0 if ctx.has_h0 else None), None


def ssd_scan(u, a, Bm, Cm, h0=None, *, chunk: int):
    """The SSD core of a Mamba2 layer: (y, h_final). Differentiable on
    both routes: CPU tensors run `ssd_scan_plain` under torch autograd,
    CUDA tensors the kernels of `SSDScan`; there is no fallback from one
    to the other. A DTensor or FakeTensor (either device) goes through
    `SSDScan` and the custom ops."""
    _check(u, a, Bm, Cm, h0)
    if u.device.type not in ("cpu", "cuda"):
        raise _not_here(u)
    if u.device.type == "cpu" and not _traced(u):
        return ssd_scan_plain(u, a, Bm, Cm, h0, chunk=chunk)
    return SSDScan.apply(u, a, Bm, Cm, h0, chunk)
