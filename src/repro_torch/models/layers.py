"""Shared model primitives: norms, RoPE, MLPs, embeddings.

Counterpart of the JAX package's ``models/layers.py``. ``p`` is the layer's
parameter dict (an ``nn.ParameterDict`` of the port's ``TransformerLM``)
under the reference's names and layouts. ``rms_norm`` goes through kernel
B2 (with its gradient, ``kernels/rmsnorm/ops.py``, when one is needed).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rmsnorm.ops import rms_norm as _rms_norm_op
from repro_torch.parallel.sharding import PDef, batch_shards, batch_sum


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


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       z_loss: float = 1e-4) -> torch.Tensor:
    """Masked cross-entropy with z-loss, in f32: the mean over the (masked)
    positions of lse − logit[label] + z_loss·lse². The row max that steadies
    the log-sum-exp carries no gradient, as in the reference; the label's
    logit is a gather where the reference contracts with a one-hot, which
    computes the same value. Inside a ``data_parallel`` split the mean is
    taken over the whole batch's positions, so that the shares' losses sum
    to the batch's."""
    logits = logits.float()
    m = torch.amax(logits, -1, keepdim=True).detach()
    z = torch.sum(torch.exp(logits - m), -1)
    lse = torch.log(z) + m[..., 0]
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - picked
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    n = batch_shards()
    if n > 1:  # a share of a data-parallel batch: over the batch's count
        if mask is None:
            return torch.sum(nll) / (nll.numel() * n)
        return torch.sum(nll * mask) / torch.clamp(
            batch_sum(torch.sum(mask)), min=1.0)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
