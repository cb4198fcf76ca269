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
(params, AdamW's or Adafactor's state, the error-feedback residuals,
counts) across the same way, onto a mesh if given its layouts, and
``state_to_numpy`` carries the port's back, gathered whole.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import TransformerLM, model_defs
from repro_torch.parallel.sharding import PDef, distribute, map_defs


def host_tensor(arr, device) -> torch.Tensor:
    """A numpy array (bfloat16 too), or a host tensor, as a tensor on
    ``device``."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # numpy's extension type, 2 bytes
        host = torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    else:
        host = torch.from_numpy(np.array(arr))
    return host.to(device)


def _convert(defs, tree, device: torch.device, path: str):
    if isinstance(defs, PDef):
        t = host_tensor(tree, device)
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


def _factored_defs(defs, key: str):
    """PDefs of Adafactor's ``vr`` (the parameter's shape without its last
    dim) or ``vc`` (without its second-to-last; ``(0,)`` for a vector)."""
    def one(d: PDef) -> PDef:
        shp = d.shape
        if len(shp) >= 2:
            shp = shp[:-1] if key == "vr" else shp[:-2] + shp[-1:]
        elif key == "vc":
            shp = (0,)
        return PDef(shp, (None,) * len(shp))

    return map_defs(one, defs)


def train_state_from_reference(cfg: ArchConfig, state: dict,
                               device=None, shardings=None) -> dict:
    """The reference's train state (numpy leaves) as the port's, tensors on
    ``device`` (None: the card): ``params`` in the stacked tree of
    ``model_defs(cfg)`` (checked by name and shape); ``opt`` AdamW's
    (``m``, ``v``, ``count``: ``init_train_state``'s) or Adafactor's
    (``m``, ``vr``, ``vc``, ``count``: ``init_factored_state``'s); the
    error-feedback residuals ``ef`` where present; ``step``. With
    ``shardings`` (a tree of ``parallel/sharding.py`` NamedSharding of the
    state's structure, as ``launch/steps.py`` ``build_train_step`` gives
    them) each leaf becomes a DTensor of which each rank keeps its shard.
    The model trains through ``TransformerLM.from_stacked(cfg,
    out["params"])``, or a mesh step."""
    device = resolve_device(device)
    defs = model_defs(cfg)
    opt = state["opt"]
    if set(opt) not in ({"m", "v", "count"}, {"m", "vr", "vc", "count"}):
        raise ValueError(f"opt: keys {sorted(opt)}, neither AdamW's nor "
                         f"Adafactor's")
    new_opt = {"count": host_tensor(opt["count"], device)}
    for key in sorted(set(opt) - {"count"}):
        kdefs = _factored_defs(defs, key) if key in ("vr", "vc") else defs
        new_opt[key] = _convert(kdefs, opt[key], device, f"opt/{key}")
    out = {"params": _convert(defs, state["params"], device, "params"),
           "opt": new_opt, "step": host_tensor(state["step"], device)}
    if "ef" in state:
        out["ef"] = _convert(defs, state["ef"], device, "ef")
    if shardings is not None:
        out = tree_map(distribute, out, shardings)
    return out


def state_to_numpy(state: dict) -> dict:
    """A tree of tensors as a tree of numpy arrays on the host, in the
    reference's structure: bfloat16 leaves as their uint16 bits (view them
    as ``ml_dtypes.bfloat16`` to hand them to JAX). A DTensor leaf is
    gathered whole (on every rank: call it on all of them)."""
    from repro_torch.checkpoint.checkpointer import _host_array

    return tree_map(_host_array, state)
