"""Plain PyTorch attention, the counterpart of the JAX package's
``kernels/flash_attention/ref.py``: naive softmax attention with the
reference's mask value and its cast of the probabilities to v's dtype
before the PV product. k and v may carry fewer heads than q (GQA); each
K/V head then serves H/K consecutive query heads, as ``_repeat_kv`` lays
them out."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, K, S, D) with K dividing H.
    Returns (B, H, S, D)."""
    s = q.shape[2]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        qi = torch.arange(s, device=q.device)[:, None]
        ki = torch.arange(s, device=q.device)[None, :]
        mask = ki <= qi
        if window:
            mask &= ki > qi - window
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.exp(logits - torch.amax(logits, -1, keepdim=True))
    probs = probs / torch.sum(probs, -1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
