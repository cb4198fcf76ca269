"""Public flash-attention entry point: the kernel wrapper, which launches
the CUDA kernel for tensors on the card and takes its plain PyTorch version
for tensors on the CPU; with a gradient, an ``autograd.Function`` around
it.

The JAX package has no backward kernel (its training differentiates the
einsum attention), so the gradient here is written out as PyTorch ops, the
same on both devices, and never calls the plain version or a library
attention. ``flash_attention_backward`` takes the saved q, k, v and
recomputes the probabilities P in f32 one block of ``BLOCK_Q`` query rows
at a time, over the keys that block can see (causal: up to its last row,
and from its first row's window on), so no (B, H, S, S) tensor is ever
whole. It rounds what ``jax.grad`` of ``kernels/flash_attention/ref.py``
rounds (P to v's dtype before dV, dP from do·vᵀ in v's dtype, the score
gradient to q's dtype before dq and dk), but forms the scores themselves
in f32, where the plain version rounds q·kᵀ to a bf16 input's dtype first.
The dK and dV products take f32 operands (the rounded values above), so
they are summed in f32 over the blocks and over the H/K query heads of
each K/V head (GQA) and rounded once, as ``jax.grad`` rounds them. The softmax gradient is
P·(dP − Σ P·dP), row by row, so the output o is not needed.

When nothing needs a gradient (serving, or under ``no_grad``),
``flash_attention`` is the wrapper's call as it was: no Function, nothing
saved.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import NEG_INF

BLOCK_Q = 256  # query rows a backward block recomputes P for


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             scale: Optional[float] = None,
                             block: int = BLOCK_Q
                             ) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of o = attention(q, k, v) for the cotangent ``do`` of
    o: q, do (B, H, S, D); k, v (B, K, S, D), K dividing H."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    window = window if causal else 0
    qg = q.reshape(b, kh, g, s, d)
    dog = do.reshape(b, kh, g, s, d)
    dq = torch.empty_like(qg)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kf = k.float()
    for i0 in range(0, s, block):
        i1 = min(s, i0 + block)
        lo, hi = 0, s
        if causal:
            hi = i1
            if window:
                lo = max(0, i0 - window + 1)
        qb, dob = qg[:, :, :, i0:i1], dog[:, :, :, i0:i1]
        kb, vb = k[:, :, lo:hi], v[:, :, lo:hi]
        scores = torch.einsum("bkgqd,bktd->bkgqt", qb.float(),
                              kf[:, :, lo:hi]) * scale
        if causal:
            qi = torch.arange(i0, i1, device=q.device)[:, None]
            ki = torch.arange(lo, hi, device=q.device)[None, :]
            mask = ki <= qi
            if window:
                mask &= ki > qi - window
            scores = torch.where(mask, scores, NEG_INF)
        p = torch.exp(scores - torch.amax(scores, -1, keepdim=True))
        p = p / torch.sum(p, -1, keepdim=True)
        del scores
        dp = torch.einsum("bkgqd,bktd->bkgqt", dob, vb).float()
        ds = p * (dp - torch.sum(p * dp, -1, keepdim=True))
        del dp
        dsl = (ds * scale).to(q.dtype)
        del ds
        dq[:, :, :, i0:i1] = torch.einsum("bkgqt,bktd->bkgqd", dsl, kb)
        dk[:, :, lo:hi] += torch.einsum("bkgqt,bkgqd->bktd", dsl.float(),
                                        qb.float())
        dv[:, :, lo:hi] += torch.einsum("bkgqt,bkgqd->bktd",
                                        p.to(v.dtype).float(), dob.float())
    return dq.reshape(q.shape), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """B3 in the forward, ``flash_attention_backward`` in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention_cuda(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, do.contiguous(), causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, K, S, D), K dividing H -> (B, H, S, D)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)
