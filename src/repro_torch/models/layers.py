"""Shared model primitives: norms, RoPE, MLPs, embeddings.

Counterpart of the JAX package's ``models/layers.py``. ``p`` is the layer's
parameter dict (an ``nn.ParameterDict`` of the port's ``TransformerLM``)
under the reference's names and layouts. ``rms_norm`` goes through kernel
B2. ``cross_entropy_loss`` waits for the training slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rmsnorm.ops import rms_norm as _rms_norm_op
from repro_torch.parallel.sharding import PDef


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm_defs(d: int) -> dict:
    return {"scale": PDef((d,), ("unsharded",), init="ones",
                          dtype=torch.float32)}


def rms_norm(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    """f32 arithmetic, cast back to x's dtype: kernel B2 on the card."""
    return _rms_norm_op(x, p["scale"], eps=eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq). Computed in f32, cast back to x's dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": PDef((d, f), ("fsdp", "ffn")),
            "w_up": PDef((d, f), ("fsdp", "ffn")),
            "w_down": PDef((f, d), ("ffn", "fsdp")),
        }
    return {
        "w_up": PDef((d, f), ("fsdp", "ffn")),
        "w_down": PDef((f, d), ("ffn", "fsdp")),
    }


def mlp_apply(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        # jax.nn.gelu defaults to the tanh approximation; torch's to exact
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------

def embedding_defs(cfg: ArchConfig) -> dict:
    v, d = cfg.padded_vocab(), cfg.d_model
    defs = {"embed": PDef((v, d), ("vocab", "fsdp"), scale=1.0,
                          init="fan_in")}
    if not cfg.tie_embeddings:
        defs["unembed"] = PDef((d, v), ("fsdp", "vocab"))
    return defs


def embed_tokens(cfg: ArchConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens]


def lm_logits(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ p["embed"].T
    return x @ p["unembed"]
