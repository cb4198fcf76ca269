"""Int8 gradient compression with error feedback.

Counterpart of the JAX package's ``optim/grad_compression.py``: per-tensor
symmetric int8 quantization, and the error-feedback construction that
re-injects each step's residual the next step, so that the optimizer stays
unbiased in the long run. The reference applies it around the cross-pod
gradient reduction of its mesh train step; the port's mesh path comes with
the multi-card training slice, and these functions are held here to the
reference's on the CPU. Functional: new trees are returned.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch._tree import leaves, tree_map, unflatten_like


def compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization. Returns (q, scale)."""
    gf = g.float()
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_with_feedback(grads: Any, residuals: Any):
    """Returns (decompressed_grads, new_residuals).

    g' = Q(g + r);  r' = (g + r) - g'  — the standard EF-SGD construction."""
    def one(g, r):
        corrected = g.float() + r
        approx = decompress(*compress(corrected))
        return approx, corrected - approx

    outs = [one(g, r) for g, r in zip(leaves(grads), leaves(residuals))]
    return (unflatten_like(grads, [o[0] for o in outs]),
            unflatten_like(grads, [o[1] for o in outs]))


def compression_ratio() -> float:
    return 4.0  # f32 -> int8 wire bytes on the compressed reduce
