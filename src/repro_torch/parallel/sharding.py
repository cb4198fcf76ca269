"""Declarative parameter definitions: the part of the JAX package's
``parallel/sharding.py`` that the models need on one card.

A ``PDef`` keeps its logical axes so that layouts stay those of the
reference, but nothing here shards: there is one card and no mesh, so the
reference's ``shard_act`` calls are dropped from the models.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch


@dataclass(frozen=True)
class PDef:
    """Declarative parameter: shape + logical axes + initializer."""

    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | scaled
    scale: float = 0.02
    dtype: Any = None  # None => model dtype; norms default float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _map_defs(fn, defs: Any) -> Any:
    if isinstance(defs, PDef):
        return fn(defs)
    return {k: _map_defs(fn, v) for k, v in defs.items()}


def stack_defs(defs: Any, num: int) -> Any:
    """Add a leading stacked-layers axis to every PDef in a tree."""
    return _map_defs(lambda d: PDef((num,) + d.shape, ("layers",) + d.axes,
                                    d.init, d.scale, d.dtype), defs)


def init_from_defs(generator: torch.Generator, defs: Any,
                   dtype: torch.dtype) -> Any:
    """Materialize parameters from defs on the generator's device, by the
    reference's rule: zeros and ones; otherwise f32 normal draws times
    ``scale`` (``init="normal"``) or 1/sqrt(fan_in) with fan_in =
    ``shape[-2]``, cast to the leaf's dtype. The numbers are not JAX's:
    tests that compare the two packages carry weights across instead."""
    device = generator.device

    def one(d: PDef) -> torch.Tensor:
        dt = d.dtype or dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale if d.init == "normal" else 1.0 / (fan_in ** 0.5)
        draw = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                           device=device)
        return (draw * std).to(dt)

    return _map_defs(one, defs)
