"""Plain PyTorch RMSNorm, the counterpart of the JAX package's
``kernels/rmsnorm/ref.py``: f32 arithmetic, cast back to x's dtype; and
its gradient, the plain version of B2's backward kernel."""
from __future__ import annotations

import torch


def rms_norm_ref(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rms_norm_backward_ref(x: torch.Tensor, scale: torch.Tensor,
                          g: torch.Tensor, eps: float = 1e-5
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of y = rms_norm_ref(x, scale) for the cotangent g of y,
    in f32 with x̂ = x·rstd and rstd = rsqrt(mean(x²) + eps):

        dx     = rstd · (g·scale − x̂ · mean(x̂ · g·scale))  (x's dtype)
        dscale = Σ over the rows of g · x̂                   (f32)

    which is what ``jax.grad`` of the JAX package's
    ``kernels/rmsnorm/ref.py`` gives."""
    xf = x.float()
    rstd = torch.rsqrt(torch.mean(torch.square(xf), -1, keepdim=True) + eps)
    xhat = xf * rstd
    gs = g.float() * scale
    dx = rstd * (gs - xhat * torch.mean(xhat * gs, -1, keepdim=True))
    dscale = torch.sum((g.float() * xhat).reshape(-1, x.shape[-1]), 0)
    return dx.to(x.dtype), dscale
