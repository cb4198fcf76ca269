"""Plain PyTorch attention, the counterpart of the JAX package's
``kernels/flash_attention/ref.py``: naive softmax attention with the
reference's mask value and its cast of the probabilities to v's dtype
before the PV product. k and v may carry fewer heads than q (GQA); each
K/V head then serves H/K consecutive query heads, as ``_repeat_kv`` lays
them out."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _mask(q: torch.Tensor, k: torch.Tensor, window: int,
          q_offset: int) -> torch.Tensor:
    """(Sq, Sk): query row i, at position ``q_offset + i`` of the keys'
    sequence, sees key j where j <= q_offset + i (and j > q_offset + i -
    window with a window)."""
    qi = torch.arange(q_offset, q_offset + q.shape[2],
                      device=q.device)[:, None]
    ki = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = ki <= qi
    if window:
        mask &= ki > qi - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, K, Sk, D) with K dividing H, query row
    i at position ``q_offset + i`` of the keys' sequence.
    Returns (B, H, Sq, D)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        logits = torch.where(_mask(q, k, window, q_offset), logits, NEG_INF)
    probs = torch.exp(logits - torch.amax(logits, -1, keepdim=True))
    probs = probs / torch.sum(probs, -1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      scale: Optional[float] = None,
                      q_offset: int = 0) -> torch.Tensor:
    """Each row's log-sum-exp of its masked, scaled logits, formed in f32
    from q and k as the kernels form them, in the log2 domain (natural
    log-sum-exp times log2 e): (B, H, Sq) f32, what the forward kernels
    write with ``return_lse``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        logits = torch.where(_mask(q, k, window, q_offset), logits, NEG_INF)
    return torch.logsumexp(logits, -1) * math.log2(math.e)


# bf16's unit roundoff: 8 significant bits, rounded to nearest, so a value
# moves by at most 2^-8 of itself
BF16_UNIT = 2.0 ** -8
# f32 sums over up to 2048 keys move o by at most 2048 * 2^-24 = 2^-13 of
# the same sum that bounds P's rounding, BF16_UNIT / 32; allowed twice that
F32_SLACK = 1.0 / 16


def bf16_error_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: int = 0, q_offset: int = 0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(o32, bound) for bf16 q, k, v: ``o32`` is the attention in f32 on the
    same bf16 values, and ``bound`` bounds |o - o32| elementwise for any
    kernel that rounds each probability p (scaled by any positive factor,
    before PV) and the output o to bf16, each to nearest:

        |o - o32| <= BF16_UNIT * (1 + F32_SLACK) * (attn(|v|) + |o32|)

    P's rounding moves o by at most BF16_UNIT * sum(p |v|) / l, which is
    attn(|v|), the attention of |v| with the same weights; o's rounding by
    BF16_UNIT |o|. A dropped or misplaced key tile moves o by a share of
    the weights it carries, which at S = 2048 is far above this bound while
    it is still far below a flat 3e-2."""
    q32, k32, v32 = (t.float() for t in (q, k, v))
    o32 = attention_ref(q32, k32, v32, causal=causal, window=window,
                        q_offset=q_offset)
    spread = attention_ref(q32, k32, v32.abs(), causal=causal, window=window,
                           q_offset=q_offset)
    bound = BF16_UNIT * (1 + F32_SLACK) * (spread + o32.abs())
    return o32, bound
