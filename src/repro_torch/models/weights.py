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
random streams. ``train_state_from_reference`` carries a whole train state
(params, AdamW moments, counts) across the same way, and
``state_to_numpy`` carries the port's back.
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


def train_state_from_reference(cfg: ArchConfig, state: dict,
                               device=None) -> dict:
    """The reference's train state (``launch/steps.py``
    ``init_train_state``'s tree, numpy leaves): ``params`` and the AdamW
    moments ``opt.m``, ``opt.v`` in the stacked tree of ``model_defs(cfg)``
    (checked by name and shape), ``opt.count`` and ``step``, as the port's
    train state of tensors on ``device`` (None: the card). The model
    trains through ``TransformerLM.from_stacked(cfg, out["params"])``."""
    device = resolve_device(device)
    defs = model_defs(cfg)
    opt = state["opt"]
    return {"params": _convert(defs, state["params"], device, "params"),
            "opt": {"m": _convert(defs, opt["m"], device, "opt/m"),
                    "v": _convert(defs, opt["v"], device, "opt/v"),
                    "count": _tensor(opt["count"], device)},
            "step": _tensor(state["step"], device)}


def state_to_numpy(state: dict) -> dict:
    """A tree of tensors as a tree of numpy arrays on the host, in the
    reference's structure: bfloat16 leaves as their uint16 bits (view them
    as ``ml_dtypes.bfloat16`` to hand them to JAX)."""
    from repro_torch._tree import tree_map
    from repro_torch.checkpoint.checkpointer import _host_array

    return tree_map(_host_array, state)
