"""Public RMSNorm entry point: the kernel wrapper, which launches the CUDA
kernel for tensors on the card and takes its plain PyTorch version for
tensors on the CPU; with a gradient, an ``autograd.Function`` around it.

``RmsNormFn`` runs B2's forward (``rms_norm_cuda``) and, in the backward,
B2's gradient kernel (``rms_norm_backward_cuda``; on the CPU its plain
version ``rms_norm_backward_ref``), so the CPU tests drive the same
Function the card runs. The JAX package has no backward kernel (its
training differentiates the jnp RMSNorm); the gradient is what
``jax.grad`` of its ``kernels/rmsnorm/ref.py`` gives. The forward saves x
only (rstd is recomputed in the backward). When nothing needs a gradient
(serving, or under ``no_grad``), ``rms_norm`` is the wrapper's call as it
was: no Function, nothing saved.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import (rms_norm_backward_cuda,
                                                rms_norm_cuda)


class RmsNormFn(torch.autograd.Function):
    """B2 in the forward, B2's gradient kernel in the backward."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rms_norm_cuda(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_backward_cuda(x, scale, g.contiguous(),
                                            eps=ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                dscale if ctx.needs_input_grad[1] else None, None)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,) f32. Returns x's shape and dtype."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RmsNormFn.apply(x, scale, eps)
    return rms_norm_cuda(x, scale, eps=eps)
