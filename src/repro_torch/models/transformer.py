"""Model assembly, dense family: a decoder-only LM over per-layer blocks.

Counterpart of the dense branch of the JAX package's
``models/transformer.py``. The parameters live in a :class:`TransformerLM`
(an ``nn.Module``) under the reference's names and layouts (``wq`` stays
``(d, h, hd)``), with the reference's stacked layer axis split into one
entry of ``layers`` per layer. The module-level functions keep the
reference's public signatures, with the module in the place of ``params``.

Public surface:
    model_defs(cfg)                   -> PDef tree (single source of truth)
    init_params(cfg, generator)       -> TransformerLM
    forward(cfg, model, batch)        -> (logits, aux)        [prefill]
    init_decode_state(cfg, batch, cache_len) -> state
    decode_step(cfg, model, state, tokens)   -> (logits, state) [serve]

The decode state is updated in place: ``decode_step`` writes each layer's
new K/V rows into the stacked cache and replaces ``state["pos"]``, and
returns the same dict. MoE, RWKV, Mamba, hybrid, enc-dec and VLM configs
raise ``NotImplementedError``: they wait for slice 3 of the port, with
``extract_decode_slot``/``restore_decode_slot`` (migration).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import init_from_defs, stack_defs

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def require_dense(cfg: ArchConfig) -> None:
    """The dense family is this slice; the others raise."""
    if (cfg.family != "dense" or cfg.num_experts or cfg.is_encdec
            or cfg.frontend != "none"):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): only the dense family is ported; "
            "MoE, RWKV, Mamba, hybrid, enc-dec and VLM wait for slice 3")


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def _dense_layer_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {
        "ln1": L.rms_norm_defs(d),
        "attn": attn.attention_defs(cfg),
        "ln2": L.rms_norm_defs(d),
        "mlp": L.mlp_defs(cfg),
    }


def model_defs(cfg: ArchConfig) -> dict:
    require_dense(cfg)
    return {
        "embedding": L.embedding_defs(cfg),
        "final_norm": L.rms_norm_defs(cfg.d_model),
        "layers": stack_defs(_dense_layer_defs(cfg), cfg.num_layers),
    }


def _module(tree: dict) -> nn.Module:
    """Nested dicts of tensors -> ModuleDicts over ParameterDicts."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _module(v) for k, v in tree.items()})


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class TransformerLM(nn.Module):
    """A dense decoder LM's parameters: ``embedding`` (``embed``, and
    ``unembed`` unless tied), ``final_norm`` and ``layers[i]`` (``ln1``,
    ``attn``, ``ln2``, ``mlp``), each leaf under the reference's name and
    layout. Built from ``init_params`` or from the reference's weights
    (``models/weights.py``)."""

    def __init__(self, cfg: ArchConfig, embedding: dict, final_norm: dict,
                 layers: list[dict]):
        super().__init__()
        require_dense(cfg)
        if len(layers) != cfg.num_layers:
            raise ValueError(f"{cfg.name} has {cfg.num_layers} layers, got "
                             f"{len(layers)}")
        self.cfg = cfg
        self.embedding = _module(embedding)
        self.final_norm = _module(final_norm)
        self.layers = nn.ModuleList(_module(p) for p in layers)

    @classmethod
    def from_stacked(cls, cfg: ArchConfig, tree: dict) -> "TransformerLM":
        """From a tree shaped like ``model_defs(cfg)``: the stacked layer
        leaves (leading axis L) are split into per-layer views."""
        layers = [_tree_map(lambda t, i=i: t[i], tree["layers"])
                  for i in range(cfg.num_layers)]
        return cls(cfg, tree["embedding"], tree["final_norm"], layers)


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> TransformerLM:
    """Random weights by the reference's rule (``parallel/sharding.py``
    ``init_from_defs``), drawn from ``generator`` on its device, or from a
    generator seeded 0 on ``device`` (None: the card)."""
    defs = model_defs(cfg)
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(0)
    elif device is not None and \
            torch.device(device).type != generator.device.type:
        raise ValueError(f"generator on {generator.device}, device {device}")
    return TransformerLM.from_stacked(
        cfg, init_from_defs(generator, defs, DTYPES[cfg.dtype]))


# ---------------------------------------------------------------------------
# Blocks and forward (prefill)
# ---------------------------------------------------------------------------


def _dense_block(cfg: ArchConfig, p, x: torch.Tensor, *, mode: str):
    h = attn.attention(cfg, p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps),
                       causal=True, window=cfg.sliding_window, mode=mode)
    x = x + h
    xn = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(cfg, p["mlp"], xn)


@torch.no_grad()
def forward(cfg: ArchConfig, model: TransformerLM, batch: dict, *,
            mode: str = "exec", remat: Optional[str] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits, aux): logits (B, S, padded vocab) in the model's
    dtype, aux the reference's MoE auxiliary loss, 0 for the dense family.
    ``remat`` is accepted for the reference's signature; nothing here keeps
    activations for a backward pass."""
    require_dense(cfg)
    x = L.embed_tokens(cfg, model.embedding, batch["tokens"])
    for p_l in model.layers:
        x = _dense_block(cfg, p_l, x, mode=mode)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = L.lm_logits(cfg, model.embedding, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int, *,
                      device=None) -> dict:
    """``{"pos": (batch,) int32, "kv": {"k", "v": (L, batch, len, K, hd)
    bf16}}`` on ``device`` (None: the card). Every slot carries its own
    position stream, so a serving slot can be reset and re-admitted
    mid-stream without aliasing cache positions across requests."""
    require_dense(cfg)
    device = resolve_device(device)
    kv = attn.init_kv_cache(cfg, batch, cache_len, window=cfg.sliding_window,
                            device=device)
    return {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "kv": {name: buf[None].repeat((cfg.num_layers,) + (1,) * buf.dim())
               for name, buf in kv.items()},
    }


def reset_decode_slots(cfg: ArchConfig, state: dict, reset_mask) -> dict:
    """Masked per-slot reset: slots where ``reset_mask`` is True restart
    their position stream at 0, without touching the other slots. KV caches
    are deliberately not cleared: ``decode_attention``'s per-row causal mask
    only exposes cache rows a slot has written since its last reset,
    including the sliding-window ring buffer, whose "fully wrapped" clause
    only unlocks after the new stream has itself written the whole ring.
    Only ``pos`` changes for the dense family; returns ``state``."""
    require_dense(cfg)
    pos = state["pos"]
    reset = torch.as_tensor(reset_mask, dtype=torch.bool, device=pos.device)
    state["pos"] = torch.where(reset, torch.zeros_like(pos), pos)
    return state


def decode_state_cache_keys(cfg: ArchConfig) -> tuple[str, ...]:
    """State keys whose leaves carry the **cache length** axis (``cache_len``
    at init; axis 2 of the stacked ``(layers, batch, len, ...)`` leaf).
    These are the leaves mid-flight migration must pad/truncate when source
    and target engines disagree on ``max_len``; recurrent leaves (RWKV/Mamba)
    are length-free and move unchanged."""
    if cfg.family == "ssm":
        return ()
    if cfg.family == "hybrid":
        return ("attn",)
    if cfg.is_encdec:
        return ("self", "cross_k", "cross_v")
    return ("kv",)


@torch.no_grad()
def decode_step(cfg: ArchConfig, model: TransformerLM, state: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """tokens: (B,) int — one step. Returns (logits (B, V), state).

    ``state["pos"]`` is a per-slot (B,) position vector (a scalar is
    broadcast); each batch row attends within its own stream only. The
    state is updated in place and returned."""
    require_dense(cfg)
    pos = torch.as_tensor(state["pos"], dtype=torch.int32,
                          device=tokens.device).expand(tokens.shape[0])
    x = L.embed_tokens(cfg, model.embedding, tokens[:, None])
    kv = state["kv"]
    for i, p_l in enumerate(model.layers):
        cache = {"k": kv["k"][i], "v": kv["v"][i]}
        xn = L.rms_norm(x, p_l["ln1"], cfg.norm_eps)
        y, _ = attn.decode_attention(cfg, p_l["attn"], xn, cache, pos,
                                     window=cfg.sliding_window)
        x = x + y
        xn = L.rms_norm(x, p_l["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(cfg, p_l["mlp"], xn)
    state["pos"] = pos + 1
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = L.lm_logits(cfg, model.embedding, x)
    return logits[:, 0], state
