"""Architecture configuration system.

Every assigned architecture gets a ``ModelConfig`` (exact paper/model-card
numbers) in ``src/repro/configs/<id>.py``.  ``reduced()`` derives the
family-preserving smoke-test variant (<=2 layers, d_model<=512, <=4 experts)
exercised on CPU; the full configs are only ever lowered via the dry-run.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Layer kinds
ATTN = "attn"
SSM = "ssm"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- attention flavour ---
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # sliding window width; None = full attention everywhere
    sliding_window: Optional[int] = None
    # local:global interleave -- every `global_every`-th layer is global
    # (0 = all layers share `sliding_window`); gemma3 uses 6 (5 local : 1 global)
    global_every: int = 0
    causal: bool = True              # False for encoder-only (hubert)

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1               # apply MoE on layers where idx % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # hybrid interleave: layers where idx % attn_period == attn_index are
    # attention, the rest SSM (0 = homogeneous per `family`)
    attn_period: int = 0
    attn_index: int = 0

    # --- modality / head ---
    is_encoder: bool = False         # no decode step (hubert)
    embed_inputs: bool = True        # False: inputs are precomputed embeddings
    num_patches: int = 0             # VLM: image patch embeddings prepended
    tie_embeddings: bool = False

    # --- numerics / partitioning knobs ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    fsdp: bool = False               # additionally shard params over data(+pod)
    remat: bool = True               # activation checkpointing on the scan body
    remat_policy: str = "full"       # full | dots (save matmul outputs)
    # beyond-paper perf knobs (see EXPERIMENTS.md §Perf)
    chunked_ce: int = 0              # >0: sequence-chunked cross-entropy
    window_kv_cache: bool = False    # SWA layers cache only the window
    banded_attention: bool = False   # skip out-of-window KV blocks (SWA)
    # round the MoE dispatch buffer (capacity+1 axis) up to a multiple, so
    # the capacity axis stays shardable over the data axis (§Perf)
    moe_pad_capacity: int = 0
    # explicit expert-parallel MoE via shard_map (local dispatch + psum over
    # the model axis) instead of GSPMD-inferred sharding (§Perf)
    moe_ep: bool = False
    # SSD chunk length Q: the intra-chunk decay matrix is O(S*Q*heads) fp32
    # of HBM traffic, so Q trades compute quadratics vs memory (§Perf)
    ssd_chunk: int = 256

    # provenance
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kind(self, idx: int) -> str:
        if self.family == "ssm":
            return SSM
        if self.family == "hybrid" and self.attn_period:
            return ATTN if idx % self.attn_period == self.attn_index else SSM
        return ATTN

    def layer_is_moe(self, idx: int) -> bool:
        if not self.num_experts:
            return False
        return idx % self.moe_every == self.moe_offset

    def layer_window(self, idx: int) -> Optional[int]:
        """Effective attention window of layer `idx` (None = full)."""
        if self.sliding_window is None:
            return None
        if self.global_every and (idx + 1) % self.global_every == 0:
            return None                      # global layer
        return self.sliding_window

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode (500k) is supported: every layer is
        either SSM or sliding-window attention with a bounded window (global
        interleave layers are decode-linear and allowed)."""
        if self.is_encoder:
            return False
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            # attention layers must be a minority & windowable; SSM carries ctx
            return True
        return self.sliding_window is not None

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        n = 0
        if self.embed_inputs:
            n += V * D
        if not self.is_encoder and not self.tie_embeddings:
            n += D * V
        elif self.is_encoder:
            n += D * V                      # prediction head
        hd = self.head_dim
        for i in range(self.num_layers):
            n += 2 * D                      # two RMSNorm gains
            if self.layer_kind(i) == ATTN:
                n += D * (self.num_heads * hd)            # wq
                n += 2 * D * (self.num_kv_heads * hd)     # wk, wv
                n += (self.num_heads * hd) * D            # wo
                if self.qk_norm:
                    n += 2 * hd
            else:
                di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
                n += D * (2 * di + 2 * N + H)             # in_proj
                n += self.ssm_conv_width * (di + 2 * N)   # conv
                n += 3 * H                                # A, dt_bias, D skip
                n += di * D                               # out_proj
                n += di                                   # gate norm
            if self.layer_is_moe(i):
                E = self.num_experts
                n += D * E                                # router
                n += E * (3 * D * F)                      # gated experts
            else:
                if F:
                    n += 3 * D * F                        # gated MLP
        n += D                                            # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.num_experts:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        total = self.param_count()
        n_moe = sum(1 for i in range(self.num_layers) if self.layer_is_moe(i))
        dead = n_moe * (self.num_experts - self.experts_per_token) * (3 * D * F)
        return total - dead

    def reduced(self) -> "ModelConfig":
        """Family-preserving smoke-test variant (2 layers, d<=512, <=4 experts)."""
        changes = dict(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=256,
            d_ff=512 if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=64 if self.num_heads else 0,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            # drop-free in smoke tests (C >= T*k); the capacity drop rule is
            # unit-tested separately against the python oracle
            capacity_factor=float(max(self.num_experts, 1)),
            moe_every=min(self.moe_every, 2) if self.num_experts else 1,
            ssm_state=min(self.ssm_state, 64) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            attn_period=2 if self.attn_period else 0,
            attn_index=1 if self.attn_period else 0,
            global_every=2 if self.global_every else 0,
            sliding_window=(64 if self.sliding_window is not None else None),
            num_patches=min(self.num_patches, 4),
            dtype="float32",
            param_dtype="float32",
            remat=False,
            fsdp=False,
        )
        if self.num_experts:
            changes["moe_offset"] = min(self.moe_offset, 1)
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


# ----------------------------------------------------------------------
# registry
_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    if not _REGISTRY:
        _load_all()
    return tuple(sorted(_REGISTRY))


def _load_all():
    # import side-effect registers every config module
    from repro_torch.configs import (  # noqa: F401
        starcoder2_3b, hubert_xlarge, jamba_v01_52b, phi3_vision_4p2b,
        dbrx_132b, kimi_k2_1t, qwen3_8b, mamba2_130m, deepseek_67b,
        gemma3_4b, opt_family,
    )


def shape_supported(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether (arch, shape) is exercised; reason recorded in DESIGN.md."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only architecture has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch without sub-quadratic variant"
    if cfg.is_encoder and shape.name == "long_500k":
        return False, "encoder-only; no long-context decode"
    return True, ""
