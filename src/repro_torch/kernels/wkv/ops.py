"""Public WKV entry point: the kernel wrapper, which launches the CUDA kernel
for tensors on the card and takes its plain PyTorch version for tensors on
the CPU."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.wkv.kernel import wkv_cuda


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor,
        u: torch.Tensor, *, state: Optional[torch.Tensor] = None,
        chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, lw: (B, H, S, D) f32; u: (H, D). Returns (out, final state
    (B, H, D, D)); a given ``state`` is updated in place and returned.
    ``chunk`` keeps the reference's signature and changes nothing: the
    chunked kernel's chunks are 64 tokens, fixed, and its arithmetic does
    not depend on them beyond rounding (``kernel.kernel_for``)."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return wkv_cuda(r, k, v, lw, u, state)
