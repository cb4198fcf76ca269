"""Carry the JAX package's weights across into the port's model.

``params_from_reference`` takes the reference's ``init_params`` tree as
nested dicts of numpy arrays (``np.asarray`` of each leaf; bf16 arrays keep
their 2-byte ``bfloat16`` dtype), with the stacked layer leaves of leading
axis L (enc-dec: ``encoder`` of leading axis ``encoder_layers`` too, and
``enc_norm`` and ``frontend`` unstacked; hybrid: ``groups`` of leading
axes (groups, attn_every), ``tail`` of leading axis tail, and
``shared_attn`` unstacked). It checks every leaf
against ``model_defs(cfg)`` by name and shape, moves it to the device and
splits the stacks per layer (``TransformerLM.from_stacked``). Nothing of the
host copy is kept once the leaf is on the device. The tests use it so that
both packages run on the same weights; the port never reproduces JAX's
random streams.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import TransformerLM, model_defs
from repro_torch.parallel.sharding import PDef


def _tensor(arr, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # numpy's extension type, 2 bytes
        host = torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    else:
        host = torch.from_numpy(np.array(arr))
    return host.to(device)


def _convert(defs, tree, device: torch.device, path: str):
    if isinstance(defs, PDef):
        t = _tensor(tree, device)
        if tuple(t.shape) != defs.shape:
            raise ValueError(f"{path}: shape {tuple(t.shape)}, the config "
                             f"wants {defs.shape}")
        return t
    if not isinstance(tree, dict) or set(tree) != set(defs):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{path or 'params'}: keys {got}, the config "
                         f"wants {sorted(defs)}")
    return {k: _convert(defs[k], tree[k], device, f"{path}/{k}")
            for k in defs}


def params_from_reference(cfg: ArchConfig, params: dict,
                          device=None) -> TransformerLM:
    """The reference's parameter tree (numpy leaves) as a TransformerLM on
    ``device`` (None: the card), mapped by name, layers split."""
    device = resolve_device(device)
    return TransformerLM.from_stacked(
        cfg, _convert(model_defs(cfg), params, device, ""))
