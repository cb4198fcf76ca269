"""LR schedules (warmup + cosine / rsqrt), in f32 as the JAX package's
``optim/schedule.py`` computes them. ``step`` is a number or a tensor; the
result is an f32 tensor on ``step``'s device (the CPU for a number)."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  floor: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos


def rsqrt(step, *, warmup: int = 100) -> torch.Tensor:
    step = _f32(step)
    w = float(max(warmup, 1))
    return torch.minimum(step / w,
                         torch.sqrt(w / torch.clamp(step, min=1.0)))
