"""Public flash-attention entry point: the kernel wrapper, which launches
the CUDA kernel for tensors on the card and takes its plain PyTorch version
for tensors on the CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, K, S, D), K dividing H -> (B, H, S, D)."""
    return flash_attention_cuda(q, k, v, causal=causal, window=window)
