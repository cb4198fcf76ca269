"""Shared model primitives: norms, RoPE, MLPs, embeddings.

Counterpart of the JAX package's ``models/layers.py``. ``p`` is the layer's
parameter dict (an ``nn.ParameterDict`` of the port's ``TransformerLM``)
under the reference's names and layouts. ``rms_norm`` goes through kernel
B2 (with its gradient, ``kernels/rmsnorm/ops.py``, when one is needed).

In a mesh step's model-parallel region (``parallel/sharding.py``
``model_parallel``) a block may hold only this rank's chunk of its ffn
columns or vocab rows; it reads that off the leaf's shape (narrower than
the config's) and computes its chunk, between ``enter`` and ``leave``:
the MLP on its ffn columns, the embedding lookup on its vocab rows, the
logits on its vocab chunk, and the cross-entropy over the vocab shards.
With whole leaves each function is the single-device one. Under a
sequence split of the residual stream (``seq_parallel``, Megatron-SP)
the stream is this rank's rows: ``rms_norm`` runs on them, the MLP's
``enter`` all-gathers its input's sequence and its ``leave``
reduce-scatters the partial output into them (an MLP with whole leaves
takes its own rows of its output), the lookup ends in a reduce-scatter
into them (its own rows where the table is whole), and the logits
gather the sequence whole before the head, so that the logits and the
loss keep the unsplit region's layout. In a prefill that keeps the
blocks' inner sequence on "model" too (the reference's ``seq_inner``,
``SeqSplit.inner``) the MLP, with whole leaves, and the head, against the
whole vocab, compute on this rank's rows with no sequence collective: the
logits stay the rows'.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rmsnorm.ops import rms_norm as _rms_norm_op
from repro_torch.parallel.sharding import (
    PDef, batch_shards, batch_sum, current_seq_split, enter, leave,
    model_index, model_max, on_rows,
)


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
    """With this rank's ffn columns of ``w_gate``/``w_up`` and rows of
    ``w_down`` (a model split), the partial outputs summed by ``leave``."""
    split = p["w_up"].shape[1] != cfg.d_ff
    rows = on_rows(split)  # seq_inner: this rank's rows, no gather
    x = x if rows else enter(x, split)
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        # jax.nn.gelu defaults to the tanh approximation; torch's to exact
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    out = h @ p["w_down"]
    return out if rows else leave(out, split)


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


def embed_tokens(cfg: ArchConfig, p, tokens: torch.Tensor,
                 front: int = 0) -> torch.Tensor:
    """The tokens' rows; from this rank's vocab rows only (a model split),
    the other ranks' tokens read zeros, and ``leave`` sums the ranks'
    lookups into every row. Under a sequence split the result is this
    rank's rows of the stream: of the lookup with ``front`` rows of zeros
    in front of it (where the VLM's patches go), a reduce-scatter of the
    ranks' lookups where the table is split (the reference's
    ``shard_act`` on the lookup), its own rows where not. Without one,
    ``front`` adds nothing."""
    table = p["embed"]
    rows = table.shape[0]
    split = rows != cfg.padded_vocab()
    if split:
        idx = tokens.long() - model_index() * rows
        inside = (idx >= 0) & (idx < rows)
        x = table[idx.clamp(0, rows - 1)]
        x = torch.where(inside[..., None], x, x.new_zeros(()))
    else:
        x = table[tokens]
    if front and current_seq_split() is not None:
        x = torch.cat([x.new_zeros((x.shape[0], front) + x.shape[2:]), x],
                      dim=1)
    return leave(x, split)


def lm_logits(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Logits; over this rank's vocab chunk where the table is split.
    Under a sequence split ``x`` is this rank's rows, gathered whole
    along the sequence before the head, or, where the rules keep the
    inner sequence on "model" (``seq_inner``), the rows' logits against
    the whole vocab."""
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    split = w.shape[1] != cfg.padded_vocab()
    return (x if on_rows(split) else enter(x, split)) @ w


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       z_loss: float = 1e-4,
                       vocab: Optional[int] = None) -> torch.Tensor:
    """Masked cross-entropy with z-loss, in f32: the mean over the (masked)
    positions of lse − logit[label] + z_loss·lse². The row max that steadies
    the log-sum-exp carries no gradient, as in the reference; the label's
    logit is a gather where the reference contracts with a one-hot, which
    computes the same value. Inside a ``data_parallel`` split the mean is
    taken over the whole batch's positions, so that the shares' losses sum
    to the batch's.

    Logits narrower than ``vocab`` are this model rank's vocab chunk: the
    max is an all-reduce MAX with no gradient, and the sum of exponentials
    and the label's logit (zero on the ranks that do not hold it) one
    all-reduce SUM whose backward is the identity (``leave``), so that
    every rank holds the whole loss and its chunk's gradient."""
    logits = logits.float()
    chunk = logits.shape[-1]
    m = torch.amax(logits, -1, keepdim=True).detach()
    if vocab is None or chunk == vocab:
        z = torch.sum(torch.exp(logits - m), -1)
        picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    else:
        m = model_max(m)
        idx = labels.long() - model_index() * chunk
        inside = (idx >= 0) & (idx < chunk)
        mine = torch.gather(logits, -1, idx.clamp(0, chunk - 1)[..., None])
        z, picked = leave(torch.stack([
            torch.sum(torch.exp(logits - m), -1),
            torch.where(inside, mine[..., 0], 0.0)]))
    lse = torch.log(z) + m[..., 0]
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
