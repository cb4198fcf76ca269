"""Public RMSNorm entry point: the kernel wrapper, which launches the CUDA
kernel for tensors on the card and takes its plain PyTorch version for
tensors on the CPU; with a gradient, an ``autograd.Function`` around it.

The JAX package has no backward kernel (its training differentiates the jnp
RMSNorm), so the gradient here is written out as PyTorch ops, the same on
both devices, and never calls the plain version: with x̂ = x·rstd and
rstd = rsqrt(mean(x²) + eps), in f32,

    dx     = rstd · (g·scale − x̂ · mean(x̂ · g·scale))   (cast to x's dtype)
    dscale = Σ over the rows of g · x̂                    (f32)

which is what ``jax.grad`` of ``kernels/rmsnorm/ref.py`` gives. The
forward saves x only (rstd is recomputed in the backward). When nothing
needs a gradient (serving, or under ``no_grad``), ``rms_norm`` is the
wrapper's call as it was: no Function, nothing saved.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rms_norm_cuda


def rms_norm_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                      eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of y = rms_norm(x, scale) for the cotangent g of y."""
    xf = x.float()
    rstd = torch.rsqrt(torch.mean(torch.square(xf), -1, keepdim=True) + eps)
    xhat = xf * rstd
    gs = g.float() * scale
    dx = rstd * (gs - xhat * torch.mean(xhat * gs, -1, keepdim=True))
    dscale = torch.sum((g.float() * xhat).reshape(-1, x.shape[-1]), 0)
    return dx.to(x.dtype), dscale


class RmsNormFn(torch.autograd.Function):
    """B2 in the forward, ``rms_norm_backward`` in the backward."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rms_norm_cuda(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_backward(x, scale, g, ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                dscale if ctx.needs_input_grad[1] else None, None)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,) f32. Returns x's shape and dtype."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RmsNormFn.apply(x, scale, eps)
    return rms_norm_cuda(x, scale, eps=eps)
