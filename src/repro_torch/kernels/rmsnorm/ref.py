"""Plain PyTorch RMSNorm, the counterpart of the JAX package's
``kernels/rmsnorm/ref.py``: f32 arithmetic, cast back to x's dtype."""
from __future__ import annotations

import torch


def rms_norm_ref(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)
