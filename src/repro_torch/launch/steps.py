"""Step builders: the (fn, layouts, input stand-ins) of every cell kind, the
one construction path that the trainer, the server and (later) the dry run
share.

Counterpart of the JAX package's ``launch/steps.py``. A ``CellProgram``
carries ``fn``, ``args`` (meta tensors: shapes and dtypes, no storage), the
in and out layouts (trees of ``parallel/sharding.py`` ``NamedSharding``),
``donate_argnums`` and a description. ``jitted()`` is a callable that
places its inputs by the in layouts (a DTensor already so laid out is
taken as it is, and updated in place where the reference donates it) and
runs ``fn``; ``lower()`` waits for the dry run (ROADMAP.md, slice 7d).

How a step computes on a mesh. The state stays laid out by the rules,
each rank holding its shards as DTensors, and no rank holds the whole
model. A step runs the model over this rank's shards
(``models/transformer.py`` ``ShardedLM``): the leaves outside the layer
loops (embedding, final and encoder norms, frontends, the hybrid's shared
attention) are gathered whole once a microbatch (a prefill, a decode
step) and held for it, and each unit of the layer loops (a layer; a
hybrid group) is gathered whole by its block as it runs
(``sharding.LayerShards``, the counterpart of the reference's
``_constrain_layer_params``), again in remat's recompute, and let go when
the block returns. So kernels B2, B3 and B4 launch on contiguous local
tensors and never see a DTensor. The gather's backward reduces each
layer's whole gradient into this rank's shard, per unit and per
microbatch: summed over the mesh dims that split the batch (a
reduce-scatter where the dim shards the leaf, an all-reduce where not),
this rank's chunk along the others; on a mesh of one rank the gather is
the state's own storage, with no copy and no collective, and the
backward accumulates straight into the shard's gradient. The batch is
split over the mesh dims on which the rules shard its batch dim (data
parallel, ``sharding.data_parallel``): the train step takes it whole on
every rank (replicated; the host's batch as it is, with no
communication) and each rank slices its rows of each microbatch, prefill
and decode take each rank's shard. The loss's and the MoE router's batch
means are taken over the whole batch, so each rank's loss is its share
of the global one.

The ranks along "model" split the blocks' arithmetic in the train and
prefill steps (``sharding.model_parallel``, Megatron's tensor
parallelism at the reference's ``shard_act`` points): each unit keeps
this rank's chunk of the leaves the rules split over "model" where the
matching activation axis is on "model" too (``transformer.model_roles``:
attention's query heads and, where they divide, its KV heads; the MLP's
and the experts' ffn columns; the vocab; the SSM and RWKV heads), and is
gathered only over the other mesh dims. A block computes its chunk
between ``enter`` and ``leave`` (an all-reduce over "model" in the
backward and in the forward), so each model rank does 1/model of a split
block's matmuls; the rest (the routers, a K/V projection of unsplit KV
heads, the SSM's B and C, RWKV's receptance and decay LoRA) each rank
computes whole, and where its ranks use such a leaf in part its gradient
is summed over "model". The embedding is a lookup over the vocab shards,
the logits this rank's vocab chunk and the loss a cross-entropy over the
shards. The sequences are not split over "model" (the reference's
Megatron-SP ``seq``, prefill's ``seq_inner`` and the flash-decode
``kv_seq``): that is ROADMAP.md's slice 7d part three. The serve step
keeps every leaf whole over "model" until then, its model ranks
computing the same rows. The optimizers update the shards, with their
global norms, scales and means reduced over the mesh (``optim/``).

``build_train_step`` keeps the reference's arithmetic: ``accum``
microbatches of ``global_batch / accum`` rows (row block j is microbatch
j), the loss the sum of the microbatch losses over ``accum``, each
microbatch's backward run before the next forward, which bounds memory to
one microbatch's activations as the reference's remat of each microbatch
does, gradients accumulated in the parameters' dtype as the reference's
scan transpose accumulates them, into buffers of the local shards'
shapes; then int8 compression with error feedback if asked, Adafactor or
AdamW, and
``step + 1``. With ``accum > 1`` the metrics are ``{"ce_loss": loss,
"moe_aux": 0}`` and the optimizer's, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import leaves, tree_map
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.lm_cost_model import Decisions
from repro_torch.launch.mesh import mesh_device
from repro_torch.models import inputs as I
from repro_torch.models import transformer as T
from repro_torch.models.weights import host_tensor
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.adafactor import (
    AdafactorConfig, adafactor_update, init_factored_state,
)
from repro_torch.optim.grad_compression import (
    compress_with_feedback, init_error_feedback,
)
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.sharding import (
    NamedSharding, ShardingRules, named_sharding, shardings_from_defs,
)


@dataclass
class CellProgram:
    fn: Callable
    args: tuple  # meta tensors (positional)
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple = ()
    description: str = ""

    def jitted(self) -> Callable:
        """``fn`` behind a placement of its inputs by ``in_shardings``."""
        def run(*args):
            return self.fn(*(place(a, s)
                             for a, s in zip(args, self.in_shardings)))
        return run

    def lower(self):
        raise NotImplementedError(
            f"lowering {self.description!r} onto a mesh without its ranks "
            f"is the dry run's, not ported yet (ROADMAP.md, slice 7d)")


def place(tree: Any, shardings: Any) -> Any:
    """Lay ``tree`` out by ``shardings`` (a tree of NamedSharding of its
    structure): a DTensor so laid out is returned as it is, another
    DTensor redistributed; a plain tensor, or numpy array, holding the
    whole value (the same on every rank) keeps this rank's chunk."""
    from torch.distributed.tensor import DTensor

    def one(x, s: NamedSharding):
        if isinstance(x, DTensor):
            if tuple(x.placements) == s.placements:
                return x
            return x.redistribute(s.mesh, s.placements)
        device = mesh_device(s.mesh)
        if not isinstance(x, torch.Tensor):
            x = host_tensor(x, device)
        return SH.distribute(x.to(device), s)

    return tree_map(one, tree, shardings)


def apply_decisions(cfg: ArchConfig, dec: Optional[Decisions]) -> ArchConfig:
    if dec is None:
        return cfg
    changes: dict[str, Any] = {"remat": dec.remat}
    if dec.accum:
        changes["accum"] = dec.accum
    return dataclasses.replace(cfg, **changes)


def _meta_params(cfg: ArchConfig) -> dict:
    dtype = T.DTYPES[cfg.dtype]
    return SH.map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype or dtype,
                                             device="meta"), T.model_defs(cfg))


def _param_shardings(cfg: ArchConfig, rules: ShardingRules, mesh):
    return shardings_from_defs(T.model_defs(cfg), rules, mesh)


def _batch_shardings(cfg, shape, rules, mesh, specs):
    axes = I.batch_logical_axes(cfg, shape)
    return {k: named_sharding(mesh, rules, axes[k], tuple(specs[k].shape))
            for k in specs}


def _replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


# ---------------------------------------------------------------------------
# The local compute of a step
# ---------------------------------------------------------------------------


def _batch_dims(t) -> tuple[int, ...]:
    """The mesh dims of more than one rank that split DTensor ``t``'s
    leading (batch) dim."""
    return tuple(SH.shard_mesh_dims(t, (0,)))


def _split_dims(sharding: NamedSharding) -> tuple[int, ...]:
    """The mesh dims of more than one rank on which ``sharding`` splits a
    tensor's leading (batch) dim."""
    from torch.distributed.tensor import Shard

    mesh = sharding.mesh
    return tuple(k for k, p in enumerate(sharding.placements)
                 if isinstance(p, Shard) and p.dim == 0 and mesh.size(k) > 1)


def _split(mesh, dims: tuple[int, ...], bdim: int) -> tuple:
    """Placements that split tensor dim ``bdim`` over mesh ``dims``."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(bdim) if k in dims else Replicate()
                 for k in range(mesh.ndim))


class _Model:
    """The ``ShardedLM`` over a step's parameters, rebuilt only when the
    state's storage changes; with ``grads``, also the gradient buffers
    its backward accumulates into: one of each parameter's local shard
    shape and dtype, zeroed by the caller before each step. ``roles``:
    ``T.model_roles``, or None for every leaf whole over "model"."""

    def __init__(self, cfg: ArchConfig, grads: bool = False,
                 roles: Optional[dict] = None):
        self.cfg, self.with_grads, self.roles = cfg, grads, roles
        self.key = None

    def __call__(self, params: dict) -> T.ShardedLM:
        key = tuple(SH.local(p).data_ptr() for p in leaves(params))
        if key != self.key:
            self.grads = (tree_map(lambda p: torch.zeros_like(SH.local(p)),
                                   params) if self.with_grads else None)
            self.model = T.ShardedLM(self.cfg, params, self.grads,
                                     roles=self.roles)
            self.key = key
        return self.model


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------


def _train_state_shardings(cfg: ArchConfig, rules, mesh, param_shapes,
                           compress_grads: bool) -> dict:
    p_shard = _param_shardings(cfg, rules, mesh)
    rep = _replicated(mesh)
    if cfg.optimizer == "adafactor":
        def full_spec(pshape, ns):
            return tuple(ns.spec) + (None,) * (pshape.dim() - len(ns.spec))

        def vr_sh(pshape, ns):
            spec = full_spec(pshape, ns)
            return NamedSharding(mesh, spec[:-1] if len(spec) >= 2 else spec)

        def vc_sh(pshape, ns):
            spec = full_spec(pshape, ns)
            if len(spec) >= 2:
                return NamedSharding(mesh, spec[:-2] + (spec[-1],))
            return NamedSharding(mesh, (None,))  # (0,) placeholder

        opt = {"m": p_shard,
               "vr": tree_map(vr_sh, param_shapes, p_shard),
               "vc": tree_map(vc_sh, param_shapes, p_shard),
               "count": rep}
    else:
        opt = {"m": p_shard, "v": p_shard, "count": rep}
    out = {"params": p_shard, "opt": opt, "step": rep}
    if compress_grads:
        out["ef"] = p_shard
    return out


def _train_state_specs(cfg: ArchConfig, compress_grads: bool = False) -> dict:
    """The train state's leaves as meta tensors (the optimizer's by
    ``cfg.optimizer``)."""
    params = _meta_params(cfg)
    opt_init = (init_factored_state if cfg.optimizer == "adafactor"
                else init_opt_state)
    state = {"params": params, "opt": opt_init(params),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    if compress_grads:
        state["ef"] = init_error_feedback(params)
    return state


def build_train_step(
    cfg: ArchConfig,
    shape: ShapeSpec,
    mesh,
    rules: ShardingRules,
    dec: Optional[Decisions] = None,
    opt_cfg: AdamWConfig = AdamWConfig(),
    mode: str = "exec",
    compress_grads: bool = False,
) -> CellProgram:
    cfg = apply_decisions(cfg, dec)
    accum = max(cfg.accum, 1)
    assert shape.global_batch % accum == 0, (shape.global_batch, accum)
    rows = shape.global_batch // accum
    model_of = _Model(cfg, grads=True, roles=T.model_roles(cfg, rules, mesh))

    batch_specs = I.input_specs(cfg, shape)
    # each microbatch's rows split over the mesh dims that the rules give
    # the batch dim; the step takes the batch whole on every rank
    dims = _split_dims(_batch_shardings(cfg, shape, rules, mesh,
                                        batch_specs)["tokens"])
    shares = math.prod(mesh.size(k) for k in dims)
    if rows % shares:  # a microbatch that does not split: every rank
        dims, shares = (), 1  # computes it whole
    per = rows // shares

    def microbatch(model, mb):
        """One microbatch's forward and backward; the rest of the
        parameters, gathered whole for it, is let go on return."""
        loss, metrics = T.forward_loss(cfg, model.bind(), mb, mode=mode)
        (loss if accum == 1 else loss / accum).backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def train_step(state, batch):
        params = state["params"]
        model = model_of(params)
        for g in leaves(model_of.grads):
            g.zero_()
        whole = {k: SH.local(v) for k, v in batch.items()}
        coord = mesh.get_coordinate()
        share = 0
        for k in dims:
            share = share * mesh.size(k) + coord[k]
        total = torch.zeros((), dtype=torch.float32,
                            device=whole["tokens"].device)
        with SH.data_parallel(mesh, dims), \
                SH.model_parallel(mesh, SH.model_dim_of(mesh)):
            for j in range(accum):
                lo = j * rows + share * per
                mb = {k: v[lo:lo + per] for k, v in whole.items()}
                loss, metrics = microbatch(model, mb)
                total += loss
            if accum == 1:
                loss = SH.batch_sum(total)
                metrics = {k: SH.batch_sum(v.clone())
                           for k, v in metrics.items()}
            else:
                loss = SH.batch_sum(total) / accum
                metrics = {"ce_loss": loss,
                           "moe_aux": torch.zeros((), dtype=torch.float32,
                                                  device=loss.device)}
        grads = tree_map(SH.like, model_of.grads, params)
        if compress_grads:
            grads, _ = compress_with_feedback(grads, state["ef"])
        if cfg.optimizer == "adafactor":
            _, _, opt_metrics = adafactor_update(
                params, grads, state["opt"],
                AdafactorConfig(lr=opt_cfg.lr,
                                weight_decay=opt_cfg.weight_decay))
        else:
            _, _, opt_metrics = adamw_update(params, grads, state["opt"],
                                             opt_cfg)
        SH.assign(state, "step", SH.local(state["step"]) + 1)
        return state, dict(metrics, loss=loss, **opt_metrics)

    state_specs = _train_state_specs(cfg, compress_grads)
    state_shardings = _train_state_shardings(
        cfg, rules, mesh, state_specs["params"], compress_grads)
    return CellProgram(
        fn=train_step,
        args=(state_specs, batch_specs),
        in_shardings=(state_shardings,
                      {k: _replicated(mesh) for k in batch_specs}),
        out_shardings=(state_shardings, None),
        donate_argnums=(0,),
        description=f"train_step {cfg.name} {shape.name} accum={accum} "
                    f"remat={cfg.remat}",
    )


def init_train_state(cfg: ArchConfig,
                     generator: Optional[torch.Generator] = None, *,
                     device=None, compress_grads: bool = False) -> dict:
    """``{"params": the stacked parameter tree, "opt": AdamW's m, v (f32)
    and count, "step": 0}`` (and ``"ef"``, f32 zeros, with
    ``compress_grads``) on ``device`` (None: the card), weights from
    ``init_param_tree``. As in the reference, the state is AdamW's
    whatever ``cfg.optimizer`` says; ``init_factored_state`` makes
    Adafactor's."""
    device = resolve_device(device)
    params = T.init_param_tree(cfg, generator, device=device)
    state = {"params": params, "opt": init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if compress_grads:
        state["ef"] = init_error_feedback(params)
    return state


# ---------------------------------------------------------------------------
# Prefill (inference forward)
# ---------------------------------------------------------------------------


def build_prefill_step(
    cfg: ArchConfig,
    shape: ShapeSpec,
    mesh,
    rules: ShardingRules,
    dec: Optional[Decisions] = None,
    mode: str = "exec",
) -> CellProgram:
    """``fn(params, batch) -> logits``, a DTensor laid out as the
    reference's last ``shard_act`` leaves them, ``("batch", "seq_inner",
    "act_vocab")``: split over the batch's mesh dims like the batch, and
    over "model" along the vocab where the model ranks computed their
    vocab chunks."""
    from torch.distributed.tensor import Shard

    cfg = apply_decisions(cfg, dec)
    model_of = _Model(cfg, roles=T.model_roles(cfg, rules, mesh))
    mdim = SH.model_dim_of(mesh)

    def prefill_step(params, batch):
        model = model_of(params).bind()
        dims = _batch_dims(batch["tokens"])
        split = _split(mesh, dims, 0)
        mine = {k: SH.to_placements(v, split) for k, v in batch.items()}
        with SH.data_parallel(mesh, dims), SH.model_parallel(mesh, mdim):
            logits, _ = T.forward(cfg, model, mine, mode=mode, remat="none")
        vocab = cfg.padded_vocab()
        if logits.shape[-1] != vocab:  # this rank's vocab chunk
            split = tuple(Shard(2) if k == mdim else pl
                          for k, pl in enumerate(split))
        return SH.from_local(logits, mesh, split,
                             (shape.global_batch,) + logits.shape[1:-1]
                             + (vocab,))

    batch_specs = I.input_specs(cfg, shape)
    return CellProgram(
        fn=prefill_step,
        args=(_meta_params(cfg), batch_specs),
        in_shardings=(_param_shardings(cfg, rules, mesh),
                      _batch_shardings(cfg, shape, rules, mesh, batch_specs)),
        out_shardings=None,
        description=f"prefill_step {cfg.name} {shape.name}",
    )


# ---------------------------------------------------------------------------
# Decode (serve_step: one token against a seq_len cache)
# ---------------------------------------------------------------------------


def _map_axes(fn, axes: Any, tree: Any) -> Any:
    """``fn(logical axes, leaf)`` over a logical-axes tree (tuples at its
    leaves) and the tree of its structure."""
    if isinstance(axes, dict):
        return {k: _map_axes(fn, axes[k], tree[k]) for k in axes}
    return fn(tuple(axes), tree)


def _state_shardings(cfg, state_shapes, rules, mesh):
    axes = T.decode_state_logical_axes(cfg, state_shapes)
    return _map_axes(lambda ax, s: named_sharding(mesh, rules, ax,
                                                  tuple(s.shape)),
                     axes, state_shapes)


def build_serve_step(
    cfg: ArchConfig,
    shape: ShapeSpec,
    mesh,
    rules: ShardingRules,
    dec: Optional[Decisions] = None,
) -> CellProgram:
    """``fn(params, state, tokens) -> (logits, state)``: the state updated
    in place in its layout (the reference donates it), the logits laid
    out ``("batch", "act_vocab")``. Every leaf is gathered whole over
    "model" and the model ranks compute the same rows: the flash-decode
    split (the cache over ``kv_seq``) is slice 7d part three's."""
    model_of = _Model(cfg)
    state_shapes = T.init_decode_state(cfg, shape.global_batch,
                                       shape.seq_len, device="meta")
    s_shard = _state_shardings(cfg, state_shapes, rules, mesh)
    tok_spec = torch.empty((shape.global_batch,), dtype=torch.int32,
                           device="meta")
    tok_shard = named_sharding(mesh, rules, ("batch",), tuple(tok_spec.shape))
    logits_shard = named_sharding(
        mesh, rules, ("batch", "act_vocab"),
        (shape.global_batch, cfg.padded_vocab()))

    def serve_step(params, state, tokens):
        model = model_of(params).bind()
        dims = _batch_dims(tokens)

        def split(t):  # the batch is axis 1 of every stacked leaf
            return _split(mesh, dims, 0 if t.dim() == 1 else 1)

        mine = tree_map(lambda t: SH.to_placements(t, split(t)), state)
        with SH.data_parallel(mesh, dims):
            logits, mine = T.decode_step(cfg, model, mine,
                                         SH.to_placements(tokens,
                                                          split(tokens)))

        def put(t, part):
            back = SH.from_placements(part, mesh, split(t), t.placements,
                                      t.shape)
            if back.data_ptr() != SH.local(t).data_ptr():
                SH.local(t).copy_(back)

        tree_map(put, state, mine)
        out = SH.from_placements(logits, mesh, split(tokens),
                                 logits_shard.placements,
                                 (shape.global_batch, logits.shape[-1]))
        return (SH.from_local(out, mesh, logits_shard.placements,
                              (shape.global_batch, logits.shape[-1])), state)

    return CellProgram(
        fn=serve_step,
        args=(_meta_params(cfg), state_shapes, tok_spec),
        in_shardings=(_param_shardings(cfg, rules, mesh), s_shard, tok_shard),
        out_shardings=(logits_shard, s_shard),
        donate_argnums=(1,),
        description=f"serve_step {cfg.name} {shape.name} "
                    f"cache={shape.seq_len}",
    )


def build_cell_program(cfg, shape, mesh, rules, dec=None, mode="exec"
                       ) -> CellProgram:
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, rules, dec, mode=mode)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, rules, dec, mode=mode)
    return build_serve_step(cfg, shape, mesh, rules, dec)
