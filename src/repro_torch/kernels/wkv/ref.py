"""Plain PyTorch WKV6, the counterpart of the JAX package's
``kernels/wkv/ref.py``: the naive sequential scan.

    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T    (w_t = exp(lw_t), decay on k-dim)
"""
from __future__ import annotations

from typing import Optional

import torch


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lw: torch.Tensor, u: torch.Tensor,
            state: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, lw: (B, H, S, D) float32; u: (H, D); state: (B, H, D, D) or
    None (zeros). Returns (out (B, H, S, D) in r's dtype, final state f32).
    ``state`` itself is not changed."""
    b, h, s, d = r.shape
    S = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
         if state is None else state.float().clone())
    out = torch.empty((b, h, s, d), dtype=torch.float32, device=r.device)
    uu = u.float()[None, :, :, None]
    for t in range(s):
        r_t, k_t, v_t = r[:, :, t].float(), k[:, :, t].float(), \
            v[:, :, t].float()
        kv = k_t[..., :, None] * v_t[..., None, :]  # (B,H,D,Dv)
        out[:, :, t] = torch.einsum("bhd,bhdv->bhv", r_t, S + uu * kv)
        S = torch.exp(lw[:, :, t].float())[..., None] * S + kv
    return out.to(r.dtype), S
