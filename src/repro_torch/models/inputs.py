"""Model-input batches per cell: their structure, and concrete synthetic
batches drawn from a numpy seed (counterpart of the JAX package's
``models/inputs.py``; the ShapeDtypeStruct stand-ins wait for the training
slice)."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeSpec


def batch_structure(cfg: ArchConfig, shape: ShapeSpec) -> dict[str, Any]:
    """(shape, dtype) description of the model-input batch for a cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((b,), torch.int32)}

    out: dict[str, Any] = {}
    if cfg.frontend == "vision":
        p = min(cfg.frontend_tokens, s // 2)
        out["patches"] = ((b, p, cfg.d_model), torch.bfloat16)
        out["tokens"] = ((b, s - p), torch.int32)
    elif cfg.frontend == "audio":
        out["frames"] = ((b, s, cfg.d_model), torch.bfloat16)
        out["tokens"] = ((b, s), torch.int32)
    else:
        out["tokens"] = ((b, s), torch.int32)
    if shape.kind == "train":
        out["labels"] = ((b, s), torch.int32)
        out["loss_mask"] = ((b, s), torch.float32)
    return out


def synthetic_batch(cfg: ArchConfig, shape: ShapeSpec, seed: int = 0, *,
                    device=None) -> dict:
    """Concrete deterministic batch on ``device`` (None: the card), drawn
    from ``np.random.default_rng(seed)``: token ids uniform in the
    vocabulary, embeddings standard normal, loss mask ones (zero over a
    vision prefix)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shp, dt) in batch_structure(cfg, shape).items():
        if dt == torch.int32:
            arr = rng.integers(0, cfg.vocab_size, shp, dtype=np.int32)
        elif name == "loss_mask":
            arr = np.ones(shp, np.float32)
        else:
            arr = rng.standard_normal(shp, dtype=np.float32)
        out[name] = torch.from_numpy(arr).to(device=device, dtype=dt)
    if "loss_mask" in out and cfg.frontend == "vision":
        p = batch_structure(cfg, shape)["patches"][0][1]
        out["loss_mask"][:, :p] = 0.0
    return out
