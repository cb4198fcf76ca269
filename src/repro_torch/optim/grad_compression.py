"""Int8 gradient compression with error feedback.

Counterpart of the JAX package's ``optim/grad_compression.py``: per-tensor
symmetric int8 quantization, and the error-feedback construction that
re-injects each step's residual the next step, so that the optimizer stays
unbiased in the long run. The reference applies it to the gradients of
its mesh train step, and so does the port's (``launch/steps.py``
``build_train_step(..., compress_grads=True)``), to the gradients after
they take the parameters' layout. ``compress_with_feedback`` returns the
decompressed gradients as a new tree and writes the new residuals into the
given ones in place.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch._tree import leaves, tree_map, unflatten_like
from repro_torch.parallel.sharding import like, local, reduce_over


def compress(g: torch.Tensor, like=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization. Returns (q, scale). ``g``
    may be the local part of DTensor ``like``: the scale is then the max
    over every shard of it."""
    gf = g.float()
    amax = torch.max(torch.abs(gf))
    if like is not None:
        reduce_over(amax, like, op="max")
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_with_feedback(grads: Any, residuals: Any):
    """Returns (decompressed_grads, residuals), the residuals updated in
    place, as the reference's train step donates them.

    g' = Q(g + r);  r' = (g + r) - g'  — the standard EF-SGD construction.
    DTensor leaves (a mesh step's) are compressed shard by shard with the
    scale of the whole leaf; g' keeps g's layout."""
    def one(g, r):
        corrected = local(g).float() + local(r)
        approx = decompress(*compress(corrected, like=r))
        local(r).copy_(corrected - approx)
        return like(approx, g)

    outs = [one(g, r) for g, r in zip(leaves(grads), leaves(residuals))]
    return unflatten_like(grads, outs), residuals


def compression_ratio() -> float:
    return 4.0  # f32 -> int8 wire bytes on the compressed reduce
