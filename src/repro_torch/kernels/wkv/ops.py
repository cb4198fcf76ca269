"""Public WKV entry point: the kernel wrapper, which launches the CUDA kernel
for tensors on the card and takes its plain PyTorch version for tensors on
the CPU; with a gradient, an ``autograd.Function`` around it.

``WkvFn`` runs B4's forward (``wkv_cuda``, the kernel ``kernel_for``
picks) and, in the backward, B4's backward kernel (``wkv_backward_cuda``;
on the CPU its plain version ``wkv_backward_ref``), so the CPU tests drive
the same Function the card runs. It takes no initial state and gives no
gradient to the final state: training passes none and reads only out
(``models/rwkv.py`` ``rwkv_time_mix``), and either raises rather than
returning a tensor cut off from its inputs.

When nothing needs a gradient (serving, decode, or under ``no_grad``),
``wkv`` is the wrapper's call as it was: no Function, nothing saved.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.wkv.kernel import wkv_backward_cuda, wkv_cuda


class WkvFn(torch.autograd.Function):
    """B4's forward, then B4's backward kernel; (out, final state)."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, lw, u)
        return wkv_cuda(r, k, v, lw, u)

    @staticmethod
    def backward(ctx, dout, dfinal):
        if dfinal is not None:
            raise NotImplementedError(
                "the WKV backward takes no gradient of the final state "
                "(training reads only out)")
        return wkv_backward_cuda(*ctx.saved_tensors, dout.float())


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor,
        u: torch.Tensor, *, state: Optional[torch.Tensor] = None,
        chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, lw: (B, H, S, D) f32; u: (H, D). Returns (out, final state
    (B, H, D, D)); a given ``state`` is updated in place and returned.
    ``chunk`` keeps the reference's signature and changes nothing: the
    chunked kernel's chunks are 64 tokens, fixed, and its arithmetic does
    not depend on them beyond rounding (``kernel.kernel_for``). Under a
    gradient, through ``WkvFn``, which takes no ``state``."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, lw, u)):
        if state is not None:
            raise NotImplementedError(
                "the WKV gradient takes no initial state: B4's backward "
                "starts from zeros, as training does")
        return WkvFn.apply(r, k, v, lw, u)
    return wkv_cuda(r, k, v, lw, u, state)
