"""Attention: GQA/MQA/MHA, RoPE, sliding window; full-sequence attention
through kernel B3 and single-token decode against a KV cache.

Counterpart of the JAX package's ``models/attention.py``. Its ``attention()``
runs the einsum ``_sdpa`` over query chunks (``mode="exec"``, a scan, or
``"probe"``, unrolled); here both modes are one call of the flash kernel,
which skips fully-masked KV tiles and reads each K/V head for its H/K query
heads itself, so nothing repeats K/V. ``decode_attention`` stays PyTorch
ops, as the reference computes it with einsums outside any kernel, and it
writes the new K/V rows into the cache in place. Cross-attention (``kv_x``,
``kv_memory``) waits for the enc-dec slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models.layers import apply_rope
from repro_torch.parallel.sharding import PDef

_CROSS = "cross-attention waits for the enc-dec slice (slice 3) of the port"


def attention_defs(cfg: ArchConfig, cross: bool = False) -> dict:
    d, h, k, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim)
    defs = {
        "wq": PDef((d, h, hd), ("fsdp", "heads", None)),
        "wk": PDef((d, k, hd), ("fsdp", "kv_heads", None)),
        "wv": PDef((d, k, hd), ("fsdp", "kv_heads", None)),
        "wo": PDef((h, hd, d), ("heads", None, "fsdp")),
    }
    if cfg.qkv_bias and not cross:
        defs["bq"] = PDef((h, hd), ("heads", None), init="zeros")
        defs["bk"] = PDef((k, hd), ("kv_heads", None), init="zeros")
        defs["bv"] = PDef((k, hd), ("kv_heads", None), init="zeros")
    return defs


def _project_q(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    return q


def _project_kv(cfg: ArchConfig, p, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def _repeat_kv(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, K, hd) -> (B, T, H, hd) by repeating each KV head H/K times.
    The flash kernel does without it; kept for callers that need the
    reference's layout."""
    if x.shape[2] == num_heads:
        return x
    return x.repeat_interleave(num_heads // x.shape[2], dim=2)


def _causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                        window: int) -> torch.Tensor:
    m = k_pos[None, :] <= q_pos[:, None]
    if window:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def _promote(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    """The dtype JAX's einsum computes a mixed pair in (bf16 with f32 is
    f32); PyTorch's einsum takes one dtype only."""
    return torch.promote_types(a.dtype, b.dtype)


# ---------------------------------------------------------------------------
# Full-sequence attention (train / prefill): kernel B3
# ---------------------------------------------------------------------------

def attention(
    cfg: ArchConfig,
    p,
    x: torch.Tensor,
    *,
    kv_x: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: int = 0,
    rope: bool = True,
    mode: str = "exec",
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Self-attention over full sequences through the flash kernel (causal
    with an optional window, or full). ``mode`` is accepted for the
    reference's signature; both of its modes are the same kernel call."""
    if kv_x is not None:
        raise NotImplementedError(_CROSS)
    s = x.shape[1]
    q = _project_q(cfg, p, x)
    k, v = _project_kv(cfg, p, x)
    if rope:
        pos = (positions if positions is not None
               else torch.arange(s, device=x.device))
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    # (B, S, heads, hd) -> (B, heads, S, hd); K/V keep their K heads
    out = flash_attention(q.transpose(1, 2).contiguous(),
                          k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(),
                          causal=causal, window=window if causal else 0)
    return torch.einsum("bhsk,hkd->bsd", out, p["wo"])


# ---------------------------------------------------------------------------
# Decode (single new token against a KV cache)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, window: int = 0,
                  *, device=None) -> dict:
    """Cache for ONE layer (callers stack over layers). Always bf16, whatever
    the model's dtype, as in the reference."""
    hd = cfg.resolved_head_dim
    length = min(max_len, window) if window else max_len
    shape = (batch, length, cfg.num_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
    }


def decode_attention(
    cfg: ArchConfig,
    p,
    x: torch.Tensor,
    cache: dict,
    pos,
    *,
    window: int = 0,
    kv_memory: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    rope: bool = True,
) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, D); pos: the current position, a scalar or a (B,) vector of
    per-slot position streams. Returns (out, cache).

    The new K/V rows are written into ``cache["k"]``/``cache["v"]`` in place
    (index assignment at slot ``pos``, or ``pos % length`` in a
    sliding-window ring buffer), so the returned cache is the one passed in:
    the reference's functional ``.at[].set`` under a donated jit buffer.
    """
    if kv_memory is not None:
        raise NotImplementedError(_CROSS)
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    scale = hd ** -0.5
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(b)

    q = _project_q(cfg, p, x)
    k_new, v_new = _project_kv(cfg, p, x)
    if rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    length = k.shape[1]
    slot = (pos % length) if window else pos
    rows = torch.arange(b, device=x.device)
    # a slot whose stream ran past the cache (an idle serving slot keeps
    # stepping) writes nothing, as JAX drops an out-of-bounds scatter
    live = (slot < length)[:, None, None]
    slot = slot.clamp(max=length - 1)
    k[rows, slot] = torch.where(live, k_new[:, 0].to(k.dtype), k[rows, slot])
    v[rows, slot] = torch.where(live, v_new[:, 0].to(v.dtype), v[rows, slot])
    idx = torch.arange(length, device=x.device)
    if window:
        # ring buffer: once wrapped, every slot holds one of the last
        # `length` positions; before wrapping only slots <= pos are live.
        mask = (idx[None, :] <= pos[:, None]) | (pos[:, None] >= length)
    else:
        # per-row causality doubles as slot-reset hygiene: rows whose
        # stream restarted at 0 can only see cache entries they have
        # (re)written since the reset.
        mask = idx[None, :] <= pos[:, None]

    # grouped GQA: no repeated copy of the cache
    kh = k.shape[2]
    g = cfg.num_heads // kh
    qg = q.reshape(b, q.shape[1], kh, g, hd)
    dt = _promote(qg, k)
    scores = torch.einsum("bqkgd,btkd->bkgqt", qg.to(dt),
                          k.to(dt)).float() * scale
    scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqt,btkd->bqkgd", probs, v)
    out = out.reshape(b, q.shape[1], cfg.num_heads, hd)
    dt = _promote(out, p["wo"])
    return torch.einsum("bshk,hkd->bsd", out.to(dt), p["wo"].to(dt)), cache
