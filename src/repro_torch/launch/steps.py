"""Step building blocks of the port's training path: the counterparts of
the JAX package's ``launch/steps.py`` ``apply_decisions`` and
``init_train_state``. The jitted mesh step builders of that module
(``build_train_step``, ``build_prefill_step``, ``build_serve_step``) come
with the multi-card training slice; on one card ``launch/train.py`` runs
the reference's single-device step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.lm_cost_model import Decisions
from repro_torch.models import transformer as T
from repro_torch.optim import init_opt_state


def apply_decisions(cfg: ArchConfig, dec: Optional[Decisions]) -> ArchConfig:
    if dec is None:
        return cfg
    changes: dict[str, Any] = {"remat": dec.remat}
    if dec.accum:
        changes["accum"] = dec.accum
    return dataclasses.replace(cfg, **changes)


def init_train_state(cfg: ArchConfig,
                     generator: Optional[torch.Generator] = None, *,
                     device=None) -> dict:
    """``{"params": the stacked parameter tree, "opt": AdamW's m, v (f32)
    and count, "step": 0}`` on ``device`` (None: the card), weights from
    ``init_param_tree``."""
    device = resolve_device(device)
    params = T.init_param_tree(cfg, generator, device=device)
    return {"params": params, "opt": init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}
