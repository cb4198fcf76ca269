"""Architecture + shape configuration system.

Every assigned architecture is a frozen ``ArchConfig``; every workload shape
is a ``ShapeSpec``. A (config, shape) pair is a *cell*; ``cell_supported``
encodes the principled skips (long_500k needs sub-quadratic attention).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Optional

# ---------------------------------------------------------------------------
# Shapes (assigned workload shapes — identical set for all 10 LM archs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    """One workload shape cell.

    kind:
      train   — lower ``train_step`` (fwd+bwd+optimizer update)
      prefill — lower ``prefill_step`` (forward, cache write)
      decode  — lower ``serve_step`` (1 new token against a seq_len KV cache)
    """

    name: str
    kind: str
    seq_len: int
    global_batch: int

    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.global_batch * self.seq_len


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


# ---------------------------------------------------------------------------
# Architectures
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int  # 0 => attention-free family
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    attn_every: int = 0  # hybrid: shared attention block after every N blocks

    # --- RWKV ---
    rwkv_head_size: int = 64
    rwkv_decay_rank: int = 64

    # --- attention details ---
    sliding_window: int = 0  # 0 = full attention
    qkv_bias: bool = False
    rope_theta: float = 10_000.0

    # --- encoder/decoder + modality frontends ---
    encoder_layers: int = 0  # >0 => encoder-decoder
    frontend: str = "none"  # none | audio | vision
    frontend_tokens: int = 0  # stub embedding sequence budget (vision)

    # --- MLP ---
    mlp_type: str = "swiglu"  # swiglu | gelu

    # --- numerics / memory policy (genome-overridable defaults) ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"  # none | dots | full
    accum: int = 1  # gradient-accumulation microbatches for train shapes
    accum_dtype: str = "float32"
    optimizer: str = "adamw"  # adamw | adafactor (factored v, 4 B/param)
    attn_chunk: int = 1_024  # query-chunk for blockwise attention
    ssm_chunk: int = 256  # intra-chunk size for SSD / WKV chunked scans

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def padded_vocab(self, multiple: int = 256) -> int:
        v = self.vocab_size
        return ((v + multiple - 1) // multiple) * multiple

    # ------------------------------------------------------------------
    # Parameter counting (used by the roofline's MODEL_FLOPS and by the
    # arithmetic-intensity narrowing stage).
    # ------------------------------------------------------------------
    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        p = self.d_model * (self.num_heads * hd)  # wq
        p += 2 * self.d_model * (self.num_kv_heads * hd)  # wk, wv
        p += (self.num_heads * hd) * self.d_model  # wo
        if self.qkv_bias:
            p += (self.num_heads + 2 * self.num_kv_heads) * hd
        return p

    def _mlp_params(self) -> int:
        n = 3 if self.mlp_type == "swiglu" else 2  # SwiGLU gate/up/down vs GELU up/down
        return n * self.d_model * self.d_ff

    def _moe_params_total(self) -> int:
        return self.num_experts * self._mlp_params() + self.d_model * self.num_experts

    def _moe_params_active(self) -> int:
        return self.experts_per_token * self._mlp_params() + self.d_model * self.num_experts

    def _mamba_params(self) -> int:
        di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
        p = self.d_model * (2 * di + 2 * ns + nh)  # in_proj (z,x,B,C,dt)
        p += (self.conv_kernel + 1) * (di + 2 * ns)  # depthwise conv + bias
        p += di * self.d_model  # out_proj
        p += 3 * nh  # A_log, D, dt_bias
        p += di  # gated norm
        return p

    def _rwkv_params(self) -> int:
        d = self.d_model
        p = 4 * d * d  # r, k, v, output
        p += d * d  # gate
        p += 2 * d * self.rwkv_decay_rank  # decay lora A, B
        p += self.d_ff * d + d * self.d_ff + d * d  # channel mix (k, v, r)
        p += 10 * d  # mus (5d+2d), decay base (d), bonus_u (d), ln_wkv (d)
        return p

    def layer_params(self, active: bool = False) -> int:
        """Parameters of one decoder block (active = MoE active subset)."""
        norms = 2 * self.d_model
        if self.family == "ssm":
            return self._rwkv_params() + norms
        if self.family == "hybrid":
            return self._mamba_params() + self.d_model  # one pre-norm
        mlp = self._mlp_params()
        if self.num_experts:
            mlp = self._moe_params_active() if active else self._moe_params_total()
        return self._attn_params() + mlp + norms

    def param_count(self, active: bool = False) -> int:
        emb = self.padded_vocab() * self.d_model
        head = emb if not self.tie_embeddings else 0
        total = emb + head + self.d_model  # + final norm
        total += self.num_layers * self.layer_params(active=active)
        if self.family == "hybrid" and self.attn_every:
            total += self._attn_params() + self.d_model  # shared attn + ln
        if self.is_encdec:
            enc_layer = self._attn_params() + self._mlp_params() + 2 * self.d_model
            total += self.encoder_layers * enc_layer + self.d_model  # + enc_norm
            # decoder cross-attention + its pre-norm
            total += self.num_layers * (self._attn_params() + self.d_model)
        if self.frontend == "vision":
            total += self.d_model * self.d_model + self.d_model  # proj + ln
        elif self.frontend == "audio":
            total += self.d_model * self.d_model  # frame proj (enc_norm above)
        return total


# ---------------------------------------------------------------------------
# Cell applicability — principled skips
# ---------------------------------------------------------------------------


def cell_supported(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch, shape) is a live dry-run cell; reason when skipped."""
    if shape.name == "long_500k":
        subq = (
            cfg.family in ("ssm", "hybrid")
            or (cfg.sliding_window and cfg.sliding_window < shape.seq_len)
        )
        if not subq:
            return False, (
                "long_500k requires sub-quadratic attention; "
                f"{cfg.name} uses full attention (skip noted in DESIGN.md)"
            )
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch config {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # Import the per-arch modules exactly once (they call register()).
    from repro_torch.configs import archs  # noqa: F401


# ---------------------------------------------------------------------------
# Reduced ("smoke") variants — same family/topology, toy dimensions.
# Used by per-arch CPU smoke tests; the full configs are only ever lowered
# via the dry-run (ShapeDtypeStruct, no allocation).
# ---------------------------------------------------------------------------


def reduced(cfg: ArchConfig) -> ArchConfig:
    num_heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    num_kv = min(cfg.num_kv_heads, num_heads) if num_heads else 0
    if num_kv and cfg.num_kv_heads == 1:
        num_kv = 1  # keep MQA topology
    head_dim = 16 if cfg.num_heads else 0
    d_model = 64
    changes = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=128,
        vocab_size=512,
        accum=1,
        attn_chunk=16,
        ssm_chunk=8,
        ssm_head_dim=8 if cfg.ssm_state else cfg.ssm_head_dim,
        ssm_state=16 if cfg.ssm_state else 0,
        rwkv_head_size=16,
        rwkv_decay_rank=8,
        frontend_tokens=8 if cfg.frontend_tokens else 0,
        sliding_window=32 if cfg.sliding_window else 0,
        attn_every=2 if cfg.attn_every else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.num_experts else 0,
    )
    return replace(cfg, **changes)


def smoke_shape(kind: str = "train") -> ShapeSpec:
    if kind == "decode":
        return ShapeSpec("smoke_decode", "decode", 64, 2)
    if kind == "prefill":
        return ShapeSpec("smoke_prefill", "prefill", 32, 2)
    return ShapeSpec("smoke_train", "train", 32, 2)
