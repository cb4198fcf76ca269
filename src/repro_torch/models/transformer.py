"""Model assembly, every family of ``configs/archs.py``: an LM over
per-layer blocks, with an encoder for the enc-dec family.

Counterpart of the JAX package's ``models/transformer.py``: its dense, MoE
(the dense block with ``moe_apply`` in place of the MLP), RWKV (``family ==
"ssm"``), hybrid (Mamba2 blocks with one shared attention block heading
each group of ``attn_every``, as in zamba2), enc-dec (``is_encdec``:
stubbed audio frames through ``frontend.proj`` into an unmasked encoder,
then decoder blocks with cross-attention over its memory, as in
seamless-m4t) and VLM (the dense block, with stubbed patch embeddings
through ``frontend.proj`` and ``frontend.ln`` put in front of the tokens,
as in llava) branches. The parameters live in a :class:`TransformerLM`
(an ``nn.Module``) under the reference's names and layouts (``wq`` stays
``(d, h, hd)``), with the reference's stacked layer axes split per layer:
one entry of ``layers`` a layer (dense, MoE, RWKV, VLM, and the enc-dec
decoder), of ``encoder`` an encoder layer, or ``groups[g][i]`` and
``tail[j]`` (hybrid). The module-level functions keep the reference's
public signatures, with the module in the place of ``params``.

Public surface:
    model_defs(cfg)                   -> PDef tree (single source of truth)
    param_specs(cfg, rules, mesh)     -> spec tree (parallel/sharding.py)
    init_param_tree(cfg, generator)   -> the stacked parameter tree
    init_params(cfg, generator)       -> TransformerLM
    forward(cfg, model, batch)        -> (logits, aux)        [prefill]
    forward_loss(cfg, model, batch)   -> (loss, metrics)      [train]
    bind_stacked_grads(model, params) -> stacked gradient tree
    model_roles(cfg, rules, mesh[, shape]) -> each leaf's model-parallel role
    ShardedLM(cfg, params, grads, roles).bind() -> a mesh step's model
    init_decode_state(cfg, batch, cache_len) -> state
    decode_state_logical_axes(cfg, state)    -> logical-axes tree
    decode_step(cfg, model, state, tokens)   -> (logits, state) [serve]

``forward`` and ``forward_loss`` run the same blocks (``_forward``):
``forward`` under ``no_grad``, so that serving saves nothing for a
backward and launches B2 and B3 as it always did; ``forward_loss`` with
autograd on, through the kernels' ``autograd.Function``s, each block
wrapped by ``_maybe_remat`` (``"full"``: ``torch.utils.checkpoint``
around the block; ``"dots"``: the same, saving the matmuls' outputs;
``"none"``). A model built ``from_stacked`` holds per-layer views of the
stacked leaves, so the training state keeps the reference's stacked tree
and the model trains in place through it. A mesh step runs the same
functions over a ``ShardedLM``: each block, and each layer of decode,
gathers its unit's shards whole as it runs and lets them go on return;
in a train or prefill step the residual stream between the blocks (and
an encoder's) may be this rank's rows of its sequence (Megatron-SP,
``sharding.seq_parallel``, opened by ``_forward`` for each stream). In a
mesh serve step the decode state is this rank's local storage of
each leaf (``launch/steps.py`` ``build_serve_step``): the caches its shard
of their sequence, RWKV's ``wkv`` and Mamba2's ``ssm`` its heads where
their blocks keep their heads, and the layers compute on it as they are.

The decode state is updated in place: ``decode_step`` writes each layer's
new K/V rows into the stacked cache (dense, MoE, VLM, the enc-dec
decoder's self-attention, and each hybrid group's shared attention), or
its WKV state, ``tm_x`` and ``cm_x`` (RWKV), or its Mamba ``ssm`` and
``conv`` leaves (hybrid) into the stacked recurrent leaves, replaces
``state["pos"]``, and returns the same dict. Decode takes tokens only, as
in the reference: no patches, and the enc-dec decoder attends to the
state's ``cross_k``/``cross_v``, which nothing but ``reset_decode_slots``
writes (zeros, as the reference leaves them). ``extract_decode_slot``
copies one slot's share of the state to the host and
``restore_decode_slot`` writes such a copy back into one slot, in place
(mid-flight migration, ``runtime/migration.py``).
"""
from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Optional

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch._tree import leaves, tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.inputs import batch_structure
from repro_torch.parallel.sharding import (
    KEEP, PARTIAL, LayerShards, PDef, _mesh_axis_sizes, current_context,
    current_seq_split, enter, in_context, init_from_defs, local,
    seq_inner_for, seq_parallel, seq_split_for, shifted, specs_from_defs,
    stack_defs,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def _dense_layer_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    defs = {
        "ln1": L.rms_norm_defs(d),
        "attn": attn.attention_defs(cfg),
        "ln2": L.rms_norm_defs(d),
    }
    if cfg.num_experts:
        defs["moe"] = moe_mod.moe_defs(cfg)
    else:
        defs["mlp"] = L.mlp_defs(cfg)
    return defs


def _rwkv_layer_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {
        "ln1": L.rms_norm_defs(d),
        "tm": rwkv_mod.rwkv_defs(cfg),
        "ln2": L.rms_norm_defs(d),
    }


def _mamba_layer_defs(cfg: ArchConfig) -> dict:
    return {"ln": L.rms_norm_defs(cfg.d_model),
            "mamba": ssm_mod.mamba_defs(cfg)}


def _encoder_layer_defs(cfg: ArchConfig) -> dict:
    return {
        "ln1": L.rms_norm_defs(cfg.d_model),
        "attn": attn.attention_defs(cfg),
        "ln2": L.rms_norm_defs(cfg.d_model),
        "mlp": L.mlp_defs(cfg),
    }


def _decoder_xattn_layer_defs(cfg: ArchConfig) -> dict:
    defs = _encoder_layer_defs(cfg)
    defs["ln_x"] = L.rms_norm_defs(cfg.d_model)
    defs["xattn"] = attn.attention_defs(cfg, cross=True)
    return defs


def hybrid_groups(cfg: ArchConfig) -> tuple[int, int]:
    """(num_groups, tail): zamba's shared attention block heads each group
    of ``attn_every`` Mamba layers; the ``tail`` layers after the last
    group have none."""
    g = cfg.attn_every or cfg.num_layers
    return cfg.num_layers // g, cfg.num_layers % g


def model_defs(cfg: ArchConfig) -> dict:
    defs = {"embedding": L.embedding_defs(cfg),
            "final_norm": L.rms_norm_defs(cfg.d_model)}
    if cfg.family == "hybrid":
        ng, tail = hybrid_groups(cfg)
        defs["groups"] = stack_defs(
            stack_defs(_mamba_layer_defs(cfg), cfg.attn_every), ng)
        if tail:
            defs["tail"] = stack_defs(_mamba_layer_defs(cfg), tail)
        defs["shared_attn"] = {"ln": L.rms_norm_defs(cfg.d_model),
                               "attn": attn.attention_defs(cfg)}
    elif cfg.is_encdec:
        defs["encoder"] = stack_defs(_encoder_layer_defs(cfg),
                                     cfg.encoder_layers)
        defs["enc_norm"] = L.rms_norm_defs(cfg.d_model)
        defs["layers"] = stack_defs(_decoder_xattn_layer_defs(cfg),
                                    cfg.num_layers)
    else:  # dense, MoE, VLM, RWKV
        layer = _rwkv_layer_defs if cfg.family == "ssm" else _dense_layer_defs
        defs["layers"] = stack_defs(layer(cfg), cfg.num_layers)
    if cfg.frontend != "none":  # audio: proj; vision: proj and ln
        d = cfg.d_model
        defs["frontend"] = {"proj": PDef((d, d), ("fsdp", "embed"))}
        if cfg.frontend == "vision":
            defs["frontend"]["ln"] = L.rms_norm_defs(d)
    return defs


def param_specs(cfg: ArchConfig, rules, mesh=None) -> dict:
    return specs_from_defs(model_defs(cfg), rules, mesh)


def _module(tree: dict) -> nn.Module:
    """Nested dicts of tensors -> ModuleDicts over ParameterDicts (a
    ParameterDict where a level holds a tensor, its dicts inside it)."""
    if not any(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ModuleDict({k: _module(v) for k, v in tree.items()})
    return nn.ParameterDict({
        k: nn.Parameter(v, requires_grad=False)
        if isinstance(v, torch.Tensor) else _module(v)
        for k, v in tree.items()})


class TransformerLM(nn.Module):
    """An LM's parameters: ``embedding`` (``embed``, and ``unembed`` unless
    tied), ``final_norm``, and ``layers[i]`` (dense and VLM: ``ln1``,
    ``attn``, ``ln2``, ``mlp``; MoE: ``moe`` in place of ``mlp``; RWKV:
    ``ln1``, ``tm``, ``ln2``; the enc-dec decoder: the dense layer's and
    ``ln_x``, ``xattn``) or, for the hybrid family, ``groups[g][i]`` and
    ``tail[j]`` (Mamba layers: ``ln``, ``mamba``) with one ``shared_attn``
    (``ln``, ``attn``) that heads every group. The enc-dec family also has
    ``encoder[j]`` (``ln1``, ``attn``, ``ln2``, ``mlp``) and ``enc_norm``;
    a config with a frontend has ``frontend`` (``proj``, and ``ln`` for
    vision). Each leaf under the reference's name and layout.
    Built from ``init_params`` or from the reference's weights
    (``models/weights.py``)."""

    def __init__(self, cfg: ArchConfig, embedding: dict, final_norm: dict,
                 layers: Optional[list[dict]] = None, *,
                 groups: Optional[list[list[dict]]] = None,
                 tail: Optional[list[dict]] = None,
                 shared_attn: Optional[dict] = None,
                 encoder: Optional[list[dict]] = None,
                 enc_norm: Optional[dict] = None,
                 frontend: Optional[dict] = None):
        super().__init__()
        self.cfg = cfg
        self.embedding = _module(embedding)
        self.final_norm = _module(final_norm)
        if frontend is not None:
            self.frontend = _module(frontend)
        if cfg.is_encdec:
            self.encoder = nn.ModuleList(_module(p) for p in encoder)
            self.enc_norm = _module(enc_norm)
        if cfg.family == "hybrid":
            ng, nt = hybrid_groups(cfg)
            tail = tail or []
            sizes = [len(g) for g in groups or []]
            if (layers is not None or shared_attn is None
                    or sizes != [cfg.attn_every] * ng or len(tail) != nt):
                raise ValueError(
                    f"{cfg.name} takes {ng} groups of {cfg.attn_every} "
                    f"layers, a tail of {nt} and shared_attn, got groups "
                    f"{sizes}, a tail of {len(tail)}")
            self.groups = nn.ModuleList(
                nn.ModuleList(_module(p) for p in g) for g in groups)
            self.tail = nn.ModuleList(_module(p) for p in tail)
            self.shared_attn = _module(shared_attn)
        else:
            if layers is None or len(layers) != cfg.num_layers:
                raise ValueError(f"{cfg.name} has {cfg.num_layers} layers, "
                                 f"got {0 if layers is None else len(layers)}")
            self.layers = nn.ModuleList(_module(p) for p in layers)

    @classmethod
    def from_stacked(cls, cfg: ArchConfig, tree: dict) -> "TransformerLM":
        """From a tree shaped like ``model_defs(cfg)``: the stacked layer
        leaves (leading axis L; ``encoder``'s leading axis its layers;
        hybrid: ``groups`` (ng, attn_every, ...) and ``tail`` (tail, ...))
        are split into per-layer views."""
        def split(stack, n):
            return [tree_map(lambda t, i=i: t[i], stack) for i in range(n)]

        extra = {"frontend": tree.get("frontend")}
        if cfg.is_encdec:
            extra.update(encoder=split(tree["encoder"], cfg.encoder_layers),
                         enc_norm=tree["enc_norm"])
        if cfg.family != "hybrid":
            return cls(cfg, tree["embedding"], tree["final_norm"],
                       split(tree["layers"], cfg.num_layers), **extra)
        ng, nt = hybrid_groups(cfg)
        groups = [[tree_map(lambda t, g=g, i=i: t[g, i], tree["groups"])
                   for i in range(cfg.attn_every)] for g in range(ng)]
        tail = split(tree["tail"], nt) if nt else []
        return cls(cfg, tree["embedding"], tree["final_norm"], groups=groups,
                   tail=tail, shared_attn=tree["shared_attn"], **extra)


def init_param_tree(cfg: ArchConfig,
                    generator: Optional[torch.Generator] = None, *,
                    device=None) -> dict:
    """Random weights by the reference's rule (``parallel/sharding.py``
    ``init_from_defs``) in the stacked tree of ``model_defs(cfg)``, drawn
    from ``generator`` on its device, or from a generator seeded 0 on
    ``device`` (None: the card)."""
    defs = model_defs(cfg)
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(0)
    elif device is not None and \
            torch.device(device).type != generator.device.type:
        raise ValueError(f"generator on {generator.device}, device {device}")
    return init_from_defs(generator, defs, DTYPES[cfg.dtype])


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> TransformerLM:
    """``init_param_tree``'s weights as a TransformerLM."""
    return TransformerLM.from_stacked(
        cfg, init_param_tree(cfg, generator, device=device))


def _stacked_pairs(model: TransformerLM, params: dict):
    """``(stacked leaf, per-layer index, the model's parameter)`` for every
    parameter of ``model``, a model built ``from_stacked(cfg, params)``:
    the index is () for an unstacked leaf, (i,) for ``layers``, ``encoder``
    and ``tail``, (g, i) for ``groups``."""
    def walk(tree, mod, index):
        if isinstance(tree, dict):
            for key, sub in tree.items():
                yield from walk(sub, mod[key], index)
        else:
            yield tree, index, mod

    for key, sub in params.items():
        if key in ("layers", "encoder", "tail"):
            for i, layer in enumerate(getattr(model, key)):
                yield from walk(sub, layer, (i,))
        elif key == "groups":
            for g, group in enumerate(model.groups):
                for i, layer in enumerate(group):
                    yield from walk(sub, layer, (g, i))
        else:
            yield from walk(sub, getattr(model, key), ())


def bind_stacked_grads(model: TransformerLM, params: dict) -> dict:
    """Turn on gradients for every parameter of ``model`` (built
    ``from_stacked(cfg, params)``) and give each one, as its ``.grad``, its
    view of a zeroed stacked gradient leaf; returns the gradient tree, of
    ``params``' structure, shapes and dtypes. A backward then accumulates
    into the stacked leaves in place: zero them before the next one."""
    grads = tree_map(torch.zeros_like, params)
    for (leaf, index, param), (g_leaf, _, _) in zip(
            _stacked_pairs(model, params),
            _stacked_pairs(model, grads)):
        if param.data_ptr() != leaf[index].data_ptr():
            raise ValueError("the model is not a view of the given params")
        param.requires_grad_(True)
        param.grad = g_leaf[index]
    return grads


# ---------------------------------------------------------------------------
# The model-parallel split of the leaves
# ---------------------------------------------------------------------------


def _on_model(entry) -> bool:
    return "model" in (entry if isinstance(entry, tuple) else (entry,))


def model_roles(cfg: ArchConfig, rules, mesh, shape=None) -> dict:
    """Each leaf's role in a mesh step's model-parallel region, a tree of
    ``model_defs(cfg)``'s structure (``parallel/sharding.py``
    ``LayerShards``): ``KEEP`` where the block computes with this rank's
    chunk along "model", ``PARTIAL`` where it uses the leaf whole but each
    model rank only in part, None elsewhere (every leaf, on a "model" dim
    of one rank or none). From the rules and the pruned specs: a block's
    leaves split together, where each one's spec puts "model" on the dim
    of the split's logical axis and the rules put the matching activation
    axis on "model" (and the chunk is whole heads):

    * attention (``attn``, ``xattn``, the hybrid's ``shared_attn``):
      ``wq``, ``wo``, ``bq`` on ``heads``/``act_heads``; ``wk``, ``wv``,
      ``bk``, ``bv`` on ``kv_heads``/``act_kv_heads`` with them, else
      ``PARTIAL`` (each rank projects every KV head and reads the block
      its query heads use, ``attention.kv_block``, which raises where
      there is no such block);
    * ``mlp``: ``w_gate``, ``w_up``, ``w_down`` on ``ffn``/``act_ffn``;
    * ``moe``: the experts' on ``expert_ffn``/``act_ffn``; the router
      stays whole and its gradient the same on every rank;
    * RWKV's ``tm``: ``w_r``, ``w_k``, ``w_v``, ``w_g``, ``w_o``,
      ``bonus_u``, ``ln_wkv`` on ``rwkv_heads`` where the model size
      divides the heads, and then ``mu``, ``decay_base``, ``decay_A``,
      ``decay_B`` ``PARTIAL``; ``c_k``, ``c_v`` on ``ffn``/``act_ffn``;
    * ``mamba``: ``A_log``, ``D``, ``dt_bias`` on ``ssm_heads`` and
      ``norm_scale``, ``out_proj`` on ``ssm_inner``, and then ``in_proj``,
      ``conv_w``, ``conv_b`` (whose channels are not whole heads) whole
      and ``PARTIAL``;
    * ``embedding``: ``embed`` and ``unembed`` each on ``vocab``/
      ``act_vocab``.

    The norms, the frontends and every leaf of a block that is not split
    are None: gathered whole, and their gradient the same on every rank,
    since ``enter`` sums what flows back out of the region.

    Given the step's ``shape`` (train or prefill), a residual stream
    split along its sequence over "model" (``sharding.seq_split_for``
    from its own global shape: the tokens, a vision config's patches in
    front of them; an enc-dec encoder's frames apart) makes more leaves
    ``PARTIAL``, since each model rank then computes them on its own rows
    only or, inside a split block, in part: every norm scale of the
    stream (``ln1``, ``ln2``, ``ln_x``, the hybrid's ``shared_attn``
    ``ln``, Mamba's ``ln``, ``final_norm``, the encoder's norms and
    ``enc_norm``), its frontend's ``proj`` and ``ln`` (each rank keeps its
    rows of the projection), and, where the block is split, MoE's
    ``router`` and RWKV's channel-mix ``mu_c`` and ``c_r``.

    A prefill ``shape`` whose stream keeps its inner sequence on "model"
    (``sharding.seq_inner_for``: the rules' ``seq_inner``, which the
    reference's pruning lets claim "model" before the heads, ffn and vocab
    that follow it) splits no block whose ``shard_act`` point names
    ``seq_inner``: attention (``attn``, ``xattn``, ``shared_attn``), the
    MLP, RWKV's time and channel mix, Mamba2 and the head (``unembed``, or
    the tied ``embed``) are whole on every model rank, which computes
    them on its rows; MoE's experts (``expert_ffn``, a point with no
    ``seq_inner``) keep their split. The train step ignores ``seq_inner``
    (ROADMAP.md, a named divergence)."""
    defs = model_defs(cfg)
    specs = specs_from_defs(defs, rules, mesh)
    m = _mesh_axis_sizes(mesh).get("model", 1)
    inner = (_seq_inner_keys(cfg, shape, rules, mesh)
             if shape is not None and m > 1 else ())

    def block(kind: str, d: dict, sp: dict, top) -> dict:
        out = {k: None for k in d}
        if top in inner and kind in ("attn", "xattn", "mlp", "tm",
                                     "mamba"):
            return out
        if top in inner and kind == "embedding":  # the head's leaf whole
            head = "embed" if cfg.tie_embeddings else "unembed"
            d = {k: v for k, v in d.items() if k != head}

        def split(names, axis, act, whole=True) -> bool:
            names = [n for n in names if n in d]
            return (m > 1 and whole and _on_model(rules.axis(act))
                    and all(_on_model(sp[n][d[n].axes.index(axis)])
                            for n in names))

        def put(names, role):
            out.update({n: role for n in names if n in d})

        if kind in ("attn", "xattn"):
            q = ("wq", "wo", "bq")
            kv = ("wk", "wv", "bk", "bv")
            if split(q, "heads", "act_heads"):
                put(q, KEEP)
                if split(kv, "kv_heads", "act_kv_heads"):
                    put(kv, KEEP)
                else:
                    for r in range(m):
                        attn.kv_block(cfg.num_heads, cfg.num_kv_heads, m, r)
                    put(kv, PARTIAL)
        elif kind == "mlp":
            ffn = ("w_gate", "w_up", "w_down")
            put(ffn, KEEP if split(ffn, "ffn", "act_ffn") else None)
        elif kind == "moe":
            ffn = ("w_gate", "w_up", "w_down")
            put(ffn, KEEP if split(ffn, "expert_ffn", "act_ffn") else None)
        elif kind == "tm":
            heads = ("w_r", "w_k", "w_v", "w_g", "w_o", "bonus_u", "ln_wkv")
            if split(heads, "rwkv_heads", "rwkv_heads",
                     cfg.rwkv_heads % m == 0):
                put(heads, KEEP)
                put(("mu", "decay_base", "decay_A", "decay_B"), PARTIAL)
            ffn = ("c_k", "c_v")
            put(ffn, KEEP if split(ffn, "ffn", "act_ffn") else None)
        elif kind == "mamba":
            if (split(("A_log", "D", "dt_bias"), "ssm_heads", "ssm_heads",
                      cfg.ssm_heads % m == 0)
                    and split(("norm_scale", "out_proj"), "ssm_inner",
                              "ssm_inner")):
                put(("A_log", "D", "dt_bias", "norm_scale", "out_proj"), KEEP)
                put(("in_proj", "conv_w", "conv_b"), PARTIAL)
        elif kind == "embedding":
            for n in ("embed", "unembed"):
                put((n,), KEEP if split((n,), "vocab", "act_vocab") else None)
        return out

    def walk(d, sp, key=None, top=None):
        if isinstance(d, PDef):
            return None
        if key in ("attn", "xattn", "mlp", "moe", "tm", "mamba",
                   "embedding"):
            return block(key, d, sp, top)
        return {k: walk(v, sp[k], k, top or k) for k, v in d.items()}

    roles = walk(defs, specs)
    if shape is not None and m > 1:
        for key in _seq_split_keys(cfg, shape, rules, mesh):
            roles[key] = _seq_partial(roles[key], key)
    return roles


def _streams(cfg: ArchConfig, shape) -> dict:
    """The global (batch, length, width) of each residual stream a train
    or prefill step of ``shape`` runs, by the top-level keys of
    ``model_defs(cfg)`` that compute on it: the main stream (the tokens',
    with a vision config's patches in front) and an enc-dec encoder's
    (the frames')."""
    st = batch_structure(cfg, shape)
    rows = shape.global_batch // (max(cfg.accum, 1)
                                  if shape.kind == "train" else 1)
    d = cfg.d_model
    main = st["tokens"][0][1] + (st["patches"][0][1] if "patches" in st
                                 else 0)
    out = {(rows, main, d): ("layers", "groups", "tail", "shared_attn",
                             "final_norm", "embedding")
           + (("frontend",) if cfg.frontend == "vision" else ())}
    if "frames" in st:
        enc = (rows, st["frames"][0][1], d)
        out[enc] = out.get(enc, ()) + ("encoder", "enc_norm", "frontend")
    return out


def _seq_inner_keys(cfg: ArchConfig, shape, rules, mesh) -> tuple:
    """The top-level keys of ``model_defs(cfg)`` whose blocks a prefill of
    ``shape`` computes on its streams' rows inside too (``seq_inner_for``
    of each stream's own global shape); none for a train step."""
    if shape.kind != "prefill":
        return ()
    return tuple(k for stream, keys in _streams(cfg, shape).items()
                 if seq_inner_for(stream, rules, mesh) for k in keys)


# the norms of a residual stream, by the key of their scale's parent
_NORMS = frozenset({"ln1", "ln2", "ln_x", "ln", "final_norm", "enc_norm"})


def _seq_split_keys(cfg: ArchConfig, shape, rules, mesh) -> list[str]:
    """The top-level keys of ``model_defs(cfg)`` whose leaves a train or
    prefill step of ``shape`` computes on a residual stream split along
    its sequence over "model": the main stream's (the tokens', with a
    vision config's patches in front) and an enc-dec encoder's (the
    frames'), each split where its own global shape says so."""
    if shape.kind == "decode":
        return []
    defs = model_defs(cfg)
    return list(dict.fromkeys(
        k for stream, keys in _streams(cfg, shape).items()
        if seq_split_for(stream, rules, mesh) for k in keys if k in defs))


def _seq_partial(roles, key: str):
    """``roles`` (of the subtree under ``key``) with what a sequence split
    makes ``PARTIAL`` (``model_roles``)."""
    if not isinstance(roles, dict):
        return roles
    out = {k: _seq_partial(v, k) for k, v in roles.items()}
    if key in _NORMS and "scale" in out:
        out["scale"] = PARTIAL
    elif key == "frontend":  # its "ln" is a norm
        out["proj"] = PARTIAL
    elif key == "moe" and out["w_up"] == KEEP:
        out["router"] = PARTIAL
    elif key == "tm" and out["c_k"] == KEEP:
        out["mu_c"] = out["c_r"] = PARTIAL
    return out


# the stacked trees of the layer loops, and a unit's leading layer axes
_UNIT_AXES = {"layers": 1, "encoder": 1, "groups": 2, "tail": 1}


def _whole(p):
    """A unit's parameters as its block reads them: ``p`` itself, or, in a
    mesh step, its ``LayerShards`` gathered whole. Blocks call it inside
    the function that remat wraps, so that the recompute gathers again."""
    return p.gather() if isinstance(p, LayerShards) else p


class ShardedLM:
    """A mesh step's model over this rank's shards of the stacked tree
    ``params`` (DTensors laid out by the rules): ``units[key]`` one
    ``LayerShards`` a unit of the layer loops (``layers[i]``,
    ``encoder[j]``, ``tail[j]``, and ``groups[g]``, a hybrid group's
    layers as a list, the reference's scan body), ``rest`` one of the
    leaves outside them (``embedding``, ``final_norm``, ``enc_norm``,
    ``frontend``, ``shared_attn``). With ``grads`` (a tree of the local
    shards' shapes and dtypes) the backward accumulates each shard's
    gradient there. ``roles`` (``model_roles``; None: every leaf whole)
    says which leaves each unit keeps as this rank's chunk along "model",
    and whose gradient it sums there. ``bind()`` gathers ``rest`` and
    returns what ``forward``, ``forward_loss`` and ``decode_step`` take in
    a ``TransformerLM``'s place; each block gathers its own unit as it
    runs (``_whole``), and computes its model chunk inside a step's
    ``model_parallel`` region."""

    def __init__(self, cfg: ArchConfig, params: dict,
                 grads: Optional[dict] = None, roles: Optional[dict] = None):
        self.cfg = cfg
        mesh = leaves(params)[0].device_mesh

        def unit(key, index: tuple):
            tree = params[key] if key else {
                k: v for k, v in params.items() if k not in _UNIT_AXES}
            g_tree = None if grads is None else (
                grads[key] if key else {k: grads[k] for k in tree})
            rl = None if roles is None else leaves(
                roles[key] if key else {k: roles[k] for k in tree})

            def at(ix):
                return (tree_map(lambda t: local(t)[ix], tree),
                        None if grads is None
                        else tree_map(lambda g: g[ix], g_tree))

            pl = [shifted(t.placements, _UNIT_AXES.get(key, 0))
                  for t in leaves(tree)]
            if key != "groups":
                parts, g_parts = at(index)
                return LayerShards(parts, pl, mesh, g_parts, rl)
            made = [at(index + (i,)) for i in range(cfg.attn_every)]
            return LayerShards([m[0] for m in made], pl * cfg.attn_every,
                               mesh, None if grads is None
                               else [m[1] for m in made],
                               None if rl is None else rl * cfg.attn_every)

        self.rest = unit(None, ())
        self.units = {key: [unit(key, (i,)) for i in
                            range(leaves(params[key])[0].shape[0])]
                      for key in _UNIT_AXES if key in params}
        if cfg.family == "hybrid":  # a TransformerLM's tail may be empty
            self.units.setdefault("tail", [])

    def bind(self) -> SimpleNamespace:
        return SimpleNamespace(**self.rest.gather(), **self.units)


# ---------------------------------------------------------------------------
# Blocks and forward (prefill)
# ---------------------------------------------------------------------------


def _ffn(cfg: ArchConfig, p, xn: torch.Tensor):
    """The dense block's second half: (MoE or MLP output, aux loss or
    None)."""
    if cfg.num_experts:
        return moe_mod.moe_apply(cfg, p["moe"], xn)
    return L.mlp_apply(cfg, p["mlp"], xn), None


def _dense_block(cfg: ArchConfig, p, x: torch.Tensor, *, mode: str):
    """Returns (x, the MoE aux loss or None)."""
    p = _whole(p)
    h = attn.attention(cfg, p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps),
                       causal=True, window=cfg.sliding_window, mode=mode)
    x = x + h
    h2, aux = _ffn(cfg, p, L.rms_norm(x, p["ln2"], cfg.norm_eps))
    return x + h2, aux


def _rwkv_block(cfg: ArchConfig, p, x: torch.Tensor, *, mode: str):
    p = _whole(p)
    x = x + rwkv_mod.rwkv_time_mix(
        cfg, p["tm"], L.rms_norm(x, p["ln1"], cfg.norm_eps), mode=mode)
    return x + rwkv_mod.rwkv_channel_mix(
        cfg, p["tm"], L.rms_norm(x, p["ln2"], cfg.norm_eps)), None


def _hybrid_group_block(cfg: ArchConfig, p_group, shared, x: torch.Tensor,
                        *, mode: str):
    """The shared attention block (B3), then the group's Mamba layers."""
    p_group = _whole(p_group)
    x = x + attn.attention(cfg, shared["attn"],
                           L.rms_norm(x, shared["ln"], cfg.norm_eps),
                           causal=True, mode=mode)
    for p_i in p_group:
        x = _mamba_block(cfg, p_i, x, mode=mode)
    return x


def _mamba_block(cfg: ArchConfig, p, x: torch.Tensor, *, mode: str):
    p = _whole(p)
    return x + ssm_mod.mamba_apply(
        cfg, p["mamba"], L.rms_norm(x, p["ln"], cfg.norm_eps), mode=mode)


def _encoder_block(cfg: ArchConfig, p, x: torch.Tensor, *, mode: str):
    """Unmasked self-attention (B3), then the MLP."""
    p = _whole(p)
    x = x + attn.attention(cfg, p["attn"],
                           L.rms_norm(x, p["ln1"], cfg.norm_eps),
                           causal=False, mode=mode)
    return x + L.mlp_apply(cfg, p["mlp"],
                           L.rms_norm(x, p["ln2"], cfg.norm_eps))


def _decoder_xattn_block(cfg: ArchConfig, p, x: torch.Tensor,
                         memory: torch.Tensor, *, mode: str,
                         memory_rows: Optional[bool] = None):
    """Causal self-attention (B3), cross-attention over the encoder's
    memory (PyTorch ops; ``memory_rows``: ``attention``'s), then the
    MLP."""
    p = _whole(p)
    x = x + attn.attention(cfg, p["attn"],
                           L.rms_norm(x, p["ln1"], cfg.norm_eps),
                           causal=True, mode=mode)
    x = x + attn.attention(cfg, p["xattn"],
                           L.rms_norm(x, p["ln_x"], cfg.norm_eps),
                           kv_x=memory, causal=False, rope=False, mode=mode,
                           memory_rows=memory_rows)
    return x + L.mlp_apply(cfg, p["mlp"],
                           L.rms_norm(x, p["ln2"], cfg.norm_eps))


def _stream_shape(cfg: ArchConfig, batch: dict) -> tuple[int, int, int]:
    """(rows, positions, width) of the residual stream a batch makes: the
    tokens, and a vision config's patches in front of them."""
    b, s = batch["tokens"].shape[:2]
    if cfg.frontend == "vision" and "patches" in batch:
        s += batch["patches"].shape[1]
    return b, s, cfg.d_model


def _embed_inputs(cfg: ArchConfig, model: TransformerLM,
                  batch: dict) -> torch.Tensor:
    """Token embeddings; for a vision config with ``patches`` (B, P, D) in
    the batch, the patches cast to the model's dtype, through
    ``frontend.proj`` and ``frontend.ln`` (B2), in front of them. Under a
    sequence split, this rank's rows of that one sequence: its patches'
    rows normed (the projection computed over every patch, as the
    reference computes it before the split), then its tokens' rows."""
    vision = cfg.frontend == "vision" and "patches" in batch
    front = batch["patches"].shape[1] if vision else 0
    x = L.embed_tokens(cfg, model.embedding, batch["tokens"], front)
    if vision:
        fp = model.frontend
        patches = batch["patches"].to(x.dtype) @ fp["proj"]
        split = current_seq_split()
        if split is None:
            return torch.cat([L.rms_norm(patches, fp["ln"], cfg.norm_eps),
                              x], dim=1)
        lo = split.index * x.shape[1]
        mine = patches[:, lo:lo + x.shape[1]]  # none past the patches
        if mine.shape[1]:
            x = torch.cat([L.rms_norm(mine.contiguous(), fp["ln"],
                                      cfg.norm_eps),
                           x[:, mine.shape[1]:]], dim=1)
    return x


def _encode(cfg: ArchConfig, model: TransformerLM, batch: dict, *,
            mode: str, remat: str = "none", whole: bool = True):
    """(the enc-dec family's memory, whether it is this rank's rows of
    its sequence): the stubbed ``frames`` (B, T, D) cast to the model's
    dtype, through ``frontend.proj``, the encoder layers and
    ``enc_norm``. Under a sequence split of the frames (their own length
    decides it) the encoder runs on this rank's rows of the projection,
    and the memory is its rows, or, with ``whole`` (for a decoder stream
    that is not split), gathered whole."""
    frames = batch["frames"]
    with seq_parallel(tuple(frames.shape)) as split:
        x = frames.to(DTYPES[cfg.dtype]) @ model.frontend["proj"]
        if split is not None:
            x = split.rows(x)
        block = _maybe_remat(functools.partial(_encoder_block, cfg,
                                               mode=mode), remat)
        for p_l in model.encoder:
            x = block(p_l, x)
        x = L.rms_norm(x, model.enc_norm, cfg.norm_eps)
        if split is not None and whole:
            x = enter(x, False)
    return x, split is not None and not whole


# the matmul ops whose outputs remat "dots" saves
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, remat: str):
    """``fn`` with its activations recomputed in the backward: ``"full"``
    all of them, ``"dots"`` all but the matmuls' outputs (the reference's
    ``dots_with_no_batch_dims_saveable``: the projections and the MLP's;
    attention's scores live inside B3), ``"none"``: ``fn`` itself. Remat
    changes memory, never values: the recompute runs in the context the
    forward ran in (``sharding.in_context``: the data-parallel split and
    the model-parallel region), though a card's backward runs on another
    thread."""
    if remat == "none":
        return fn
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts)

    kwargs = {"use_reentrant": False, "preserve_rng_state": False}
    if remat == "dots":
        kwargs["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _dots_policy)
    elif remat != "full":
        raise ValueError(f"remat must be none, dots or full, got {remat!r}")

    def run(*args):
        context = current_context()

        def again(*a):
            with in_context(context):
                return fn(*a)
        return checkpoint(again, *args, **kwargs)
    return run


def _forward(cfg: ArchConfig, model: TransformerLM, batch: dict, *,
             mode: str, remat: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward of ``forward`` and ``forward_loss``, each block through
    ``_maybe_remat``. In a model-parallel region the residual stream (and
    the encoder's) may be this rank's rows of its sequence
    (``sharding.seq_parallel``): the embedding, the blocks and the final
    norm then compute on those rows, and the logits gather them whole."""
    shape = _stream_shape(cfg, batch)
    if cfg.is_encdec:  # the encoder's stream first, split by its length
        with seq_parallel(shape) as split:  # whether the decoder's splits
            whole = split is None
        memory, rows = _encode(cfg, model, batch, mode=mode, remat=remat,
                               whole=whole)
    with seq_parallel(shape) as split:
        x = _embed_inputs(cfg, model, batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "hybrid":
            block = _maybe_remat(lambda p_g, x: _hybrid_group_block(
                cfg, p_g, model.shared_attn, x, mode=mode), remat)
            for p_g in model.groups:
                x = block(p_g, x)
            tail = _maybe_remat(lambda p_l, x: _mamba_block(
                cfg, p_l, x, mode=mode), remat)
            for p_l in model.tail:
                x = tail(p_l, x)
        elif cfg.is_encdec:
            block = _maybe_remat(lambda p_l, x, mem: _decoder_xattn_block(
                cfg, p_l, x, mem, mode=mode, memory_rows=rows), remat)
            for p_l in model.layers:
                x = block(p_l, x, memory)
        else:
            block = _maybe_remat(functools.partial(
                _rwkv_block if cfg.family == "ssm" else _dense_block, cfg,
                mode=mode), remat)
            for p_l in model.layers:
                x, a = block(p_l, x)
                if a is not None:
                    aux = aux + a
        x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
        logits = L.lm_logits(cfg, model.embedding, x)
    return logits, aux


@torch.no_grad()
def forward(cfg: ArchConfig, model: TransformerLM, batch: dict, *,
            mode: str = "exec", remat: Optional[str] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits, aux): logits (B, S, padded vocab) in the model's
    dtype (VLM with ``patches``: over P + S positions, the patches first),
    aux the reference's MoE auxiliary loss, an f32 scalar: the sum of the
    MoE layers' losses, 0 for the other families. The enc-dec family reads
    ``frames`` (B, T, D) beside ``tokens``. Under ``no_grad``: ``remat`` is
    accepted for the reference's signature, and nothing keeps activations
    for a backward pass (``forward_loss`` does)."""
    return _forward(cfg, model, batch, mode=mode, remat="none")


def forward_loss(cfg: ArchConfig, model: TransformerLM, batch: dict, *,
                 mode: str = "exec", remat: Optional[str] = None,
                 aux_weight: float = 0.01):
    """(loss, {"ce_loss", "moe_aux"}) with autograd on: the masked
    cross-entropy of ``batch["labels"]`` (``loss_mask`` if given) plus
    ``aux_weight`` times the MoE auxiliary loss, each block recomputed in
    the backward as ``remat`` (None: ``cfg.remat``) says."""
    remat = cfg.remat if remat is None else remat
    logits, aux = _forward(cfg, model, batch, mode=mode, remat=remat)
    loss = L.cross_entropy_loss(logits, batch["labels"],
                                batch.get("loss_mask"),
                                vocab=cfg.padded_vocab())
    return loss + aux_weight * aux, {"ce_loss": loss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int, *,
                      device=None) -> dict:
    """``{"pos": (batch,) int32, "kv": {"k", "v": (L, batch, len, K, hd)
    bf16}}`` (dense and MoE; ``len`` at most the sliding window, a ring
    buffer then), ``{"pos", "rwkv": {"wkv": (L, batch, H, hd, hd)
    f32, "tm_x", "cm_x": (L, batch, D) bf16}}`` (RWKV, no cache length),
    ``{"pos", "self": {"k", "v"}, "cross_k", "cross_v": (L, batch, len, K,
    hd) bf16 zeros}}`` (enc-dec: ``cross_*`` bf16 whatever the model's
    dtype, as in the reference) or
    ``{"pos", "mamba": {"ssm": (ng*attn_every, batch, H, hd, N) f32,
    "conv": (ng*attn_every, batch, K-1, C)}, "mamba_tail": (the same over
    the tail's layers, if any), "attn": {"k", "v": (ng, batch, len, K,
    hd) bf16}}`` (hybrid: one cache a group's shared attention; ``conv`` in
    the model's dtype, as ``models/ssm.py`` says) on ``device`` (None: the
    card). Every slot carries its own position stream, so a serving slot
    can be reset and re-admitted mid-stream without aliasing cache
    positions across requests."""
    device = resolve_device(device)

    def rep(per: dict, n: int) -> dict:
        return {name: buf[None].repeat((n,) + (1,) * buf.dim())
                for name, buf in per.items()}

    state = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.family == "ssm":
        state["rwkv"] = rep(rwkv_mod.init_rwkv_state(cfg, batch,
                                                     device=device),
                            cfg.num_layers)
    elif cfg.family == "hybrid":
        ng, tail = hybrid_groups(cfg)
        m = ssm_mod.init_ssm_state(cfg, batch, device=device)
        state["mamba"] = rep(m, ng * cfg.attn_every)
        if tail:
            state["mamba_tail"] = rep(m, tail)
        state["attn"] = rep(attn.init_kv_cache(cfg, batch, cache_len,
                                               device=device), ng)
    elif cfg.is_encdec:
        state["self"] = rep(attn.init_kv_cache(cfg, batch, cache_len,
                                               device=device),
                            cfg.num_layers)
        state["cross_k"] = torch.zeros(
            (cfg.num_layers, batch, cache_len, cfg.num_kv_heads,
             cfg.resolved_head_dim), dtype=torch.bfloat16, device=device)
        state["cross_v"] = torch.zeros_like(state["cross_k"])
    else:
        state["kv"] = rep(attn.init_kv_cache(cfg, batch, cache_len,
                                             window=cfg.sliding_window,
                                             device=device),
                          cfg.num_layers)
    return state


def decode_state_logical_axes(cfg: ArchConfig, state: dict) -> dict:
    """Logical sharding axes mirroring init_decode_state's structure."""
    kv_axes = ("layers",) + attn.cache_logical_axes()["k"]
    out: dict = {"pos": (None,)}  # (batch,) vector, replicated
    if cfg.family == "ssm":
        out["rwkv"] = {
            "wkv": ("layers", "batch", "rwkv_heads", None, None),
            "tm_x": ("layers", "batch", "embed"),
            "cm_x": ("layers", "batch", "embed"),
        }
    elif cfg.family == "hybrid":
        m_axes = {"ssm": ("layers", "batch", "ssm_heads", None, None),
                  "conv": ("layers", "batch", None, "ssm_inner")}
        out["mamba"] = m_axes
        if "mamba_tail" in state:
            out["mamba_tail"] = m_axes
        out["attn"] = {"k": kv_axes, "v": kv_axes}
    elif cfg.is_encdec:
        out["self"] = {"k": kv_axes, "v": kv_axes}
        out["cross_k"] = kv_axes
        out["cross_v"] = kv_axes
    else:
        out["kv"] = {"k": kv_axes, "v": kv_axes}
    return out


def reset_decode_slots(cfg: ArchConfig, state: dict, reset_mask) -> dict:
    """Masked per-slot reset: slots where ``reset_mask`` is True restart
    their position stream at 0, without touching the other slots. KV caches
    are deliberately not cleared: ``decode_attention``'s per-row causal mask
    only exposes cache rows a slot has written since its last reset,
    including the sliding-window ring buffer, whose "fully wrapped" clause
    only unlocks after the new stream has itself written the whole ring.
    Only ``pos`` changes for the dense family. The recurrent families carry
    their history densely in their state, so their leaves (RWKV's three;
    the hybrid's ``ssm`` and ``conv`` in ``mamba`` and ``mamba_tail``, not
    its KV caches) are zeroed in place under the mask: the fresh state of
    ``init_rwkv_state`` and ``init_ssm_state``. The enc-dec family's
    per-request memory, ``cross_k`` and ``cross_v``, is zeroed for the same
    reason. Returns ``state``."""
    pos = state["pos"]
    reset = torch.as_tensor(reset_mask, dtype=torch.bool, device=pos.device)
    state["pos"] = torch.where(reset, torch.zeros_like(pos), pos)
    leaves = [state[key] for key in ("cross_k", "cross_v") if key in state]
    for key in ("rwkv", "mamba", "mamba_tail"):
        leaves += state.get(key, {}).values()
    for leaf in leaves:
        # batch is axis 1 of every stacked leaf
        leaf.masked_fill_(reset.view((1, -1) + (1,) * (leaf.dim() - 2)), 0)
    return state


def decode_state_cache_keys(cfg: ArchConfig) -> tuple[str, ...]:
    """State keys whose leaves carry the **cache length** axis (``cache_len``
    at init; axis 2 of the stacked ``(layers, batch, len, ...)`` leaf, axis 1
    after :func:`extract_decode_slot` drops the batch axis). These are the
    leaves mid-flight migration must pad/truncate when source and target
    engines disagree on ``max_len``; recurrent leaves (RWKV/Mamba) are
    length-free and move unchanged."""
    if cfg.family == "ssm":
        return ()
    if cfg.family == "hybrid":
        return ("attn",)
    if cfg.is_encdec:
        return ("self", "cross_k", "cross_v")
    return ("kv",)


def extract_decode_slot(cfg: ArchConfig, state: dict, slot: int
                        ) -> tuple[dict, int]:
    """Host copy of ONE slot's decode state: ``(leaves, pos)``.

    Every stacked state leaf carries batch at axis 1 (the layout
    :func:`reset_decode_slots` relies on), so one slot's share is the
    ``[:, slot]`` slice of each non-``pos`` leaf, copied into a fresh
    contiguous CPU tensor. A copy, not a view: the engine updates the state
    in place, so a view would change as the slot decodes on or is reset."""
    def host(v: torch.Tensor) -> torch.Tensor:
        part = v[:, slot]
        return torch.empty(part.shape, dtype=part.dtype).copy_(part)

    leaves = {key: tree_map(host, val)
              for key, val in state.items() if key != "pos"}
    return leaves, int(state["pos"][slot])


def restore_decode_slot(cfg: ArchConfig, state: dict, slot: int,
                        leaves: dict, pos: int) -> dict:
    """Masked single-slot **write**, the restore-side dual of
    :func:`reset_decode_slots`: overwrite slot ``slot``'s share of every
    state leaf with ``leaves`` (an :func:`extract_decode_slot` payload,
    already resized to this state's cache length; cast to each leaf's
    dtype) and pin its position stream at ``pos``, in place, WITHOUT
    touching the other slots. Returns ``state``."""
    state["pos"][slot] = pos
    for key, val in state.items():
        if key == "pos":
            continue
        if isinstance(val, dict):
            for name, cur in val.items():
                cur[:, slot].copy_(leaves[key][name])
        else:
            val[:, slot].copy_(leaves[key])
    return state


@torch.no_grad()
def decode_step(cfg: ArchConfig, model: TransformerLM, state: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """tokens: (B,) int — one step. Returns (logits (B, V), state).

    ``state["pos"]`` is a per-slot (B,) position vector (a scalar is
    broadcast); each batch row attends within its own stream only. The
    state is updated in place and returned."""
    pos = torch.as_tensor(state["pos"], dtype=torch.int32,
                          device=tokens.device).expand(tokens.shape[0])
    x = L.embed_tokens(cfg, model.embedding, tokens[:, None])
    if cfg.family == "ssm":
        x = _rwkv_decode_layers(cfg, model, state["rwkv"], x)
    elif cfg.family == "hybrid":
        x = _hybrid_decode_layers(cfg, model, state, pos, x)
    elif cfg.is_encdec:
        x = _encdec_decode_layers(cfg, model, state, pos, x)
    else:
        x = _dense_decode_layers(cfg, model, state["kv"], pos, x)
    state["pos"] = pos + 1
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = L.lm_logits(cfg, model.embedding, x)
    return logits[:, 0], state


def _rwkv_decode_layers(cfg: ArchConfig, model: TransformerLM, rw: dict,
                        x: torch.Tensor) -> torch.Tensor:
    """One token through every RWKV layer; layer i's WKV state is updated in
    place by B4, its ``tm_x``/``cm_x`` rows overwritten (rounded to bf16,
    as the reference stores them)."""
    for i, p_l in enumerate(model.layers):
        x = _rwkv_decode_layer(cfg, p_l, rw, i, x)
    return x


def _rwkv_decode_layer(cfg: ArchConfig, p, rw: dict, i: int,
                       x: torch.Tensor) -> torch.Tensor:
    p = _whole(p)
    xn = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    y, _, tm_x = rwkv_mod.rwkv_time_mix(
        cfg, p["tm"], xn, mode="probe", state=rw["wkv"][i],
        last_x=rw["tm_x"][i].to(xn.dtype))
    x = x + y
    xn = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    y, cm_x = rwkv_mod.rwkv_channel_mix(
        cfg, p["tm"], xn, last_x=rw["cm_x"][i].to(xn.dtype))
    rw["tm_x"][i].copy_(tm_x)
    rw["cm_x"][i].copy_(cm_x)
    return x + y


def _dense_decode_layers(cfg: ArchConfig, model: TransformerLM, kv: dict,
                         pos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One token through every dense (or MoE) layer; each layer's new K/V
    rows are written into its cache. The MoE aux loss is dropped, as the
    reference drops it in decode."""
    for i, p_l in enumerate(model.layers):
        x = _dense_decode_layer(cfg, p_l, {"k": kv["k"][i], "v": kv["v"][i]},
                                pos, x)
    return x


def _dense_decode_layer(cfg: ArchConfig, p, cache: dict, pos: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    p = _whole(p)
    xn = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    y, _ = attn.decode_attention(cfg, p["attn"], xn, cache, pos,
                                 window=cfg.sliding_window)
    x = x + y
    return x + _ffn(cfg, p, L.rms_norm(x, p["ln2"], cfg.norm_eps))[0]


def _encdec_decode_layers(cfg: ArchConfig, model: TransformerLM, state: dict,
                          pos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One token through every decoder layer: self-attention against the
    layer's ``self`` cache (its new K/V rows written in place), then
    cross-attention to the layer's ``cross_k``/``cross_v``, which it leaves
    as they are."""
    for i, p_l in enumerate(model.layers):
        x = _encdec_decode_layer(cfg, p_l, state, i, pos, x)
    return x


def _encdec_decode_layer(cfg: ArchConfig, p, state: dict, i: int,
                         pos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    p = _whole(p)
    kv = state["self"]
    cache = {"k": kv["k"][i], "v": kv["v"][i]}
    xn = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.decode_attention(cfg, p["attn"], xn, cache, pos)[0]
    xn = L.rms_norm(x, p["ln_x"], cfg.norm_eps)
    x = x + attn.decode_attention(
        cfg, p["xattn"], xn, {}, pos, rope=False,
        kv_memory=(state["cross_k"][i], state["cross_v"][i]))[0]
    return x + L.mlp_apply(cfg, p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps))


def _hybrid_decode_layers(cfg: ArchConfig, model: TransformerLM, state: dict,
                          pos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One token through every hybrid group (the shared attention against
    the group's own KV cache, then its Mamba layers) and the tail; each
    Mamba layer's ``ssm`` and ``conv`` leaves are updated in place."""
    for g, p_g in enumerate(model.groups):
        x = _hybrid_decode_group(cfg, p_g, model.shared_attn, state, g, pos,
                                 x)
    for j, p_l in enumerate(model.tail):
        x = _mamba_decode(cfg, p_l, state["mamba_tail"], j, x)
    return x


def _hybrid_decode_group(cfg: ArchConfig, p_group, shared, state: dict,
                         g: int, pos: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    p_group = _whole(p_group)
    kv = state["attn"]
    cache = {"k": kv["k"][g], "v": kv["v"][g]}
    xn = L.rms_norm(x, shared["ln"], cfg.norm_eps)
    y, _ = attn.decode_attention(cfg, shared["attn"], xn, cache, pos)
    x = x + y
    for i, p_i in enumerate(p_group):
        x = _mamba_decode(cfg, p_i, state["mamba"], g * cfg.attn_every + i, x)
    return x


def _mamba_decode(cfg: ArchConfig, p, leaves: dict, i: int,
                  x: torch.Tensor) -> torch.Tensor:
    p = _whole(p)
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    y, _ = ssm_mod.mamba_decode_step(
        cfg, p["mamba"], xn, {"ssm": leaves["ssm"][i],
                              "conv": leaves["conv"][i]})
    return x + y
