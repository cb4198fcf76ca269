"""Public RMSNorm entry point: the kernel wrapper, which launches the CUDA
kernel for tensors on the card and takes its plain PyTorch version for
tensors on the CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rms_norm_cuda


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,) f32. Returns x's shape and dtype."""
    return rms_norm_cuda(x, scale, eps=eps)
