"""Public flash-attention entry point: the kernel wrapper, which launches
the CUDA kernel for tensors on the card and takes its plain PyTorch version
for tensors on the CPU; with a gradient, an ``autograd.Function`` around
it.

``FlashAttentionFn`` runs B3's forward with ``return_lse`` and saves q, k,
v, o and the rows' log-sum-exp; its backward is B3's backward kernel
(``flash_attention_backward_cuda``; on the CPU its plain version, below),
so the CPU tests drive the same Function the card runs. The JAX package
has no backward kernel (its training differentiates the einsum attention);
the kernel computes what ``jax.grad`` of ``kernels/flash_attention/ref.py``
computes and rounds where it rounds.

``flash_attention_backward`` is the plain version, written out as PyTorch
ops. It recomputes the probabilities P in f32 one block of ``BLOCK_Q``
query rows at a time, over the keys that block can see (causal: up to its
last row, and from its first row's window on), so no (B, H, S, S) tensor is
ever whole. Given the forward's ``o`` and ``lse`` it takes the kernel's
formulation: P = exp2(scale log2(e) q·kᵀ − lse), dP = do·vᵀ in f32, and
the softmax gradient P·(dP − D) with D = rowsum(do·o) in f32. Without them
it normalises P itself, rounds dP to v's dtype as ``jax.grad`` does, and
takes D = Σ P·dP, row by row, so o is not needed. Both round what
``jax.grad`` rounds: P to v's dtype before dV, the scaled score gradient
to q's dtype before dq and dk; they form the scores in f32, where the
plain forward rounds q·kᵀ to a bf16 input's dtype first. The dK and dV
products take f32 operands (the rounded values above), so they are summed
in f32 over the blocks and over the H/K query heads of each K/V head (GQA)
and rounded once, as ``jax.grad`` rounds them.

When nothing needs a gradient (serving, or under ``no_grad``),
``flash_attention`` is the wrapper's call as it was: no Function, nothing
saved, no log-sum-exp written.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_backward_cuda, flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import NEG_INF

BLOCK_Q = 256  # query rows a backward block recomputes P for
LOG2E = math.log2(math.e)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor, *,
                             o: Optional[torch.Tensor] = None,
                             lse: Optional[torch.Tensor] = None,
                             causal: bool = True, window: int = 0,
                             scale: Optional[float] = None,
                             block: int = BLOCK_Q
                             ) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of o = attention(q, k, v) for the cotangent ``do`` of
    o: q, do (B, H, S, D); k, v (B, K, S, D), K dividing H. With the
    forward's ``o`` (B, H, S, D) and ``lse`` (B, H, S, log2 domain), the
    kernel's formulation; both or neither."""
    if (o is None) != (lse is None):
        raise ValueError("give both o and lse, or neither")
    b, h, s, d = q.shape
    kh = k.shape[1]
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    window = window if causal else 0
    qg = q.reshape(b, kh, g, s, d)
    dog = do.reshape(b, kh, g, s, d)
    if lse is not None:
        lseg = lse.reshape(b, kh, g, s)
        dsum = (do.float() * o.float()).sum(-1).reshape(b, kh, g, s)
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
        mask = None
        if causal:
            qi = torch.arange(i0, i1, device=q.device)[:, None]
            ki = torch.arange(lo, hi, device=q.device)[None, :]
            mask = ki <= qi
            if window:
                mask &= ki > qi - window
            scores = torch.where(mask, scores, NEG_INF)
        if lse is None:
            p = torch.exp(scores - torch.amax(scores, -1, keepdim=True))
            p = p / torch.sum(p, -1, keepdim=True)
            dp = torch.einsum("bkgqd,bktd->bkgqt", dob, vb).float()
            rowsum = torch.sum(p * dp, -1, keepdim=True)
        else:
            p = torch.exp2(scores * LOG2E - lseg[:, :, :, i0:i1, None])
            if mask is not None:
                p = torch.where(mask, p, 0.0)
            dp = torch.einsum("bkgqd,bktd->bkgqt", dob.float(), vb.float())
            rowsum = dsum[:, :, :, i0:i1, None]
        del scores
        ds = p * (dp - rowsum)
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
    """B3's forward, then B3's backward kernel (the plain version on the
    CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                      return_lse=True, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = flash_attention_backward_cuda(
            *ctx.saved_tensors, do.contiguous(), causal=ctx.causal,
            window=ctx.window, q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, K, Sk, D), K dividing H -> (B, H, Sq,
    D); query row i at position ``q_offset + i`` of the keys' sequence (a
    gradient then raises in the backward, which takes one length)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
