"""Step builders: the (fn, layouts, input stand-ins) of every cell kind, the
one construction path that the trainer, the server and (later) the dry run
share.

Counterpart of the JAX package's ``launch/steps.py``. A ``CellProgram``
carries ``fn``, ``args`` (meta tensors: shapes and dtypes, no storage), the
in and out layouts (trees of ``parallel/sharding.py`` ``NamedSharding``),
``donate_argnums`` and a description. ``jitted()`` is a callable that
places its inputs by the in layouts (a DTensor already so laid out is
taken as it is, and updated in place where the reference donates it) and
runs ``fn``; ``lower()`` is the dry run's reading of the step
(``launch/dryrun.py``): ``fn`` run once on fake tensors as one rank of a
fake world, its flops, bytes, collectives and memory read off the run.

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

The ranks along "model" split the blocks' arithmetic in every step
(``sharding.model_parallel``, Megatron's tensor parallelism at the
reference's ``shard_act`` points): each unit keeps
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
shards. The train and prefill steps also split the residual stream's
sequence over "model" where the rules put ``seq`` there and the pruned
spec keeps it for the stream's own length (the reference's Megatron-SP,
``sharding.seq_parallel``, the rules handed to ``model_parallel``): the
embedding lookup ends in a reduce-scatter into this rank's rows, the
norms, the residual adds and the block inputs that remat keeps are this
rank's rows, each block's ``enter`` all-gathers the sequence and its
``leave`` reduce-scatters the partial output into the rows (a block with
no split leaf takes its own rows of its whole output), and the logits
gather the sequence whole before the head, so that the logits and the
loss keep their layout. The norm scales' gradients are then summed over
"model" (``model_roles`` with the step's shape). A prefill step also
keeps the blocks' inner sequence on "model" where the rules put
``seq_inner`` there (the reference's layout where the heads do not divide
the model size, or the genome's ``overrides``; ``sharding.seq_inner_for``):
attention, the MLP, RWKV, Mamba2 and the head are then whole on every
model rank, attention runs this rank's query rows against K and V
all-gathered along the sequence (B3 at the rows' offset), the MLP and the
head compute on the rows with no sequence collective, and the logits stay
this rank's rows; MoE's experts keep their split, and RWKV and Mamba2,
whose recurrences read the whole sequence, gather it and keep their own
rows of their output. The train step ignores ``seq_inner``. The serve
step splits the decode caches along their sequence (the
reference's flash-decode ``kv_seq``, ``sharding.kv_split``): each rank
writes and reads its shard in place, its attention whole over the
heads, the shards' softmax combined by all-reduces
(``build_serve_step``). The optimizers update the shards, with their
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
from repro_torch._tree import flatten, leaves, tree_map, unflatten_like
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
        """The dry run's reading of this step (``launch/dryrun.py``
        ``lower_program``): ``fn`` run once on fake tensors shaped by
        ``args`` and laid out by ``in_shardings``, as this rank of the fake
        world that must be running (``dryrun.fake_world``; it refuses any
        other), with the mesh and rules active (``sharding.use_mesh``).
        The name is the reference's ``jit(...).lower``: nothing is lowered
        or compiled here, and the result's ``compile()`` is itself. It has
        the reference's ``cost_analysis()`` and ``memory_analysis()``, and
        ``collective_stats()`` in place of the HLO text."""
        from repro_torch.launch.dryrun import lower_program

        return lower_program(self)


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
        # where each local shard's data starts (a fake tensor's storage:
        # the dry run's have no data, and their pointers would collide)
        key = tuple(SH.memory_key(SH.local(p)) for p in leaves(params))
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
    model_of = _Model(cfg, grads=True,
                      roles=T.model_roles(cfg, rules, mesh, shape))

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
        for k, spec in batch_specs.items():  # the roles read its lengths
            if whole[k].shape != spec.shape:
                raise ValueError(f"batch {k!r} of shape "
                                 f"{tuple(whole[k].shape)}, the step's "
                                 f"{tuple(spec.shape)}")
        coord = mesh.get_coordinate()
        share = 0
        for k in dims:
            share = share * mesh.size(k) + coord[k]
        total = torch.zeros((), dtype=torch.float32,
                            device=whole["tokens"].device)
        with SH.data_parallel(mesh, dims), \
                SH.model_parallel(mesh, SH.model_dim_of(mesh), rules):
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
    "act_vocab")`` pruned: split over the batch's mesh dims like the
    batch, and over "model" along the sequence where the rules keep the
    inner sequence there (``seq_inner``: this rank's rows against the
    whole vocab), else along the vocab where the model ranks computed
    their vocab chunks."""
    from torch.distributed.tensor import Shard

    cfg = apply_decisions(cfg, dec)
    model_of = _Model(cfg, roles=T.model_roles(cfg, rules, mesh, shape))
    mdim = SH.model_dim_of(mesh)
    # the main stream's (batch, length, width): the head computes on its
    # rows where the rules keep the inner sequence on "model"
    stream = next(iter(T._streams(cfg, shape)))
    inner = SH.seq_inner_for(stream, rules, mesh)

    def prefill_step(params, batch):
        model = model_of(params).bind()
        dims = _batch_dims(batch["tokens"])
        split = _split(mesh, dims, 0)
        mine = {k: SH.to_placements(v, split) for k, v in batch.items()}
        with SH.data_parallel(mesh, dims), \
                SH.model_parallel(mesh, mdim, rules, inner=True):
            logits, _ = T.forward(cfg, model, mine, mode=mode, remat="none")
        vocab = cfg.padded_vocab()
        if inner:  # this rank's rows
            split = tuple(Shard(1) if k == mdim else pl
                          for k, pl in enumerate(split))
        elif logits.shape[-1] != vocab:  # this rank's vocab chunk
            split = tuple(Shard(2) if k == mdim else pl
                          for k, pl in enumerate(split))
        return SH.from_local(logits, mesh, split,
                             (shape.global_batch, stream[1], vocab))

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


@dataclass(frozen=True)
class ServeLayout:
    """How the serve step computes on a mesh (``serve_layout``), by mesh
    axis names: ``batch`` the axes that split the batch (of the tokens and
    every state leaf alike), ``kv_seq`` those that split the caches'
    sequence (the flash-decode group), ``gathered`` the state leaves (paths)
    joined whole over "model" for the step, Mamba2's ``conv``."""
    batch: tuple
    kv_seq: tuple
    gathered: tuple


def _split_axes(entry, sizes: dict) -> tuple:
    """The mesh axes of more than one rank in a spec entry."""
    names = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    return tuple(a for a in names if sizes.get(a, 1) > 1)


def serve_layout(cfg: ArchConfig, shape: ShapeSpec, rules: ShardingRules,
                 mesh, roles: Optional[dict] = None) -> ServeLayout:
    """The serve step's layout of ``cfg``'s decode state on ``mesh`` under
    ``rules`` (a ``DeviceMesh`` or the stand-in of axis names and sizes),
    checked against the blocks' model-parallel roles (``roles``, by
    default ``model_roles``). Each state leaf is computed on as this
    rank's local part: the batch split as the tokens' (the layer axis
    whole); the KV caches (and enc-dec's ``cross_k``/``cross_v``) split
    along their sequence alone, all of them over the same axes, with
    attention's leaves whole (the reference's ``act_heads`` None); RWKV's
    ``wkv`` split over "model" by heads exactly where the time mix keeps
    its heads, ``tm_x``/``cm_x`` whole; Mamba2's ``ssm`` by heads exactly
    where the block keeps its heads, and ``conv`` (channels x | B | C, of
    which a plain chunk is not a rank's heads) gathered whole over "model"
    for the step. A layout that breaks one of these raises, naming the
    leaf, its shape, its spec and the mesh."""
    from repro_torch.parallel.sharding import KEEP, _mesh_axis_sizes

    roles = T.model_roles(cfg, rules, mesh) if roles is None else roles
    sizes = _mesh_axis_sizes(mesh)
    state_shapes = T.init_decode_state(cfg, shape.global_batch,
                                       shape.seq_len, device="meta")
    shardings = dict(flatten(_state_shardings(cfg, state_shapes, rules,
                                              mesh)))
    caches = T.decode_state_cache_keys(cfg)
    tokens = named_sharding(mesh, rules, ("batch",), (shape.global_batch,))
    batch = _split_axes(tokens.spec[0], sizes)
    # (block, leaf) of every leaf a block keeps as this rank's chunk
    kept = {path[-2:] for key, tree in roles.items()
            for path, role in flatten(tree, (key,)) if role == KEEP}
    for block in ("attn", "xattn"):
        if any(b == block for b, _ in kept):
            raise ValueError(
                f"serve step: {block} keeps its heads' chunk over 'model' "
                f"on mesh {sizes}, where decode reads a sequence-split "
                f"cache with every head whole")

    kv_seq, gathered = None, []
    for path, leaf in flatten(state_shapes):
        spec = tuple(shardings[path].spec)
        spec += (None,) * (leaf.dim() - len(spec))
        split = [_split_axes(e, sizes) for e in spec]

        def refuse(why: str):
            raise ValueError(f"serve step: state leaf {'/'.join(path)} of "
                             f"shape {tuple(leaf.shape)} laid out {spec} "
                             f"on mesh {sizes}: {why}")

        if path == ("pos",):
            if split[0]:
                refuse("the positions must be whole on every rank")
            continue
        if split[0]:
            refuse("its layer axis is split")
        if split[1] != batch:
            refuse(f"its batch is split over {split[1]}, the tokens' over "
                   f"{batch}")
        name = path[-1]
        if path[0] in caches:
            if kv_seq is None:
                kv_seq = split[2]
            if split[2] != kv_seq or any(split[3:]):
                refuse(f"a cache is split along its sequence over {kv_seq} "
                       f"alone")
            continue
        heads = {"wkv": ("tm", "w_r") in kept,
                 "ssm": ("mamba", "A_log") in kept}
        if name in heads:
            want = ("model",) if heads[name] else ()
            if split[2] != want or any(split[3:]):
                refuse(f"its heads must be split over {want}, as the "
                       f"blocks compute them")
        elif name == "conv":
            if split[2] or split[3] not in ((), ("model",)):
                refuse("its channels may be split over 'model' alone")
            if split[3]:
                gathered.append(path)
        elif any(split[2:]):
            refuse("it must be whole but for its batch")
    return ServeLayout(batch, kv_seq or (), tuple(gathered))


def build_serve_step(
    cfg: ArchConfig,
    shape: ShapeSpec,
    mesh,
    rules: ShardingRules,
    dec: Optional[Decisions] = None,
) -> CellProgram:
    """``fn(params, state, tokens) -> (logits, state)``: the state updated
    in place in its layout (the reference donates it), the logits laid out
    ``("batch", "act_vocab")``: each rank's rows and, where the model
    ranks computed their vocab chunks, its chunk.

    The step computes on each state leaf's local storage as the rules lay
    it out (``serve_layout``), under the data-parallel split of the batch,
    the model-parallel region (``model_roles`` under the decode rules:
    the MLP's and the experts' ffn, the vocab, the RWKV and SSM heads
    split over "model"; attention whole) and the caches' sequence split
    (``sharding.kv_split``: flash-decode over the ranks that hold the
    cache's ``kv_seq`` shards, "model", or "data" and "model" at global
    batch 1, where the batch is whole on every rank). No cache, ``wkv``
    or ``ssm`` leaf is gathered or copied: their new rows and states are
    written in place. Mamba2's ``conv`` is the one leaf gathered whole
    over "model" for the step, and this rank's chunk of it written back;
    the positions, whole on every rank, each rank steps in place. On a
    mesh of one rank this is ``decode_step`` on the state's own storage,
    with no collective."""
    roles = T.model_roles(cfg, rules, mesh)
    model_of = _Model(cfg, roles=roles)
    state_shapes = T.init_decode_state(cfg, shape.global_batch,
                                       shape.seq_len, device="meta")
    s_shard = _state_shardings(cfg, state_shapes, rules, mesh)
    tok_spec = torch.empty((shape.global_batch,), dtype=torch.int32,
                           device="meta")
    tok_shard = named_sharding(mesh, rules, ("batch",), tuple(tok_spec.shape))
    logits_shard = named_sharding(
        mesh, rules, ("batch", "act_vocab"),
        (shape.global_batch, cfg.padded_vocab()))
    layout = serve_layout(cfg, shape, rules, mesh, roles)
    names = tuple(mesh.mesh_dim_names)
    dims = tuple(names.index(a) for a in layout.batch)
    mdim = SH.model_dim_of(mesh)
    # the flash-decode group is made here, on every rank alike
    split = SH.kv_split_over(mesh, tuple(names.index(a)
                                         for a in layout.kv_seq))

    def serve_step(params, state, tokens):
        model = model_of(params).bind()
        whole = {}  # a gathered leaf's local part, by path

        def mine(path, t):
            if path == ("pos",):  # whole on every rank: this rank's rows
                return SH.local_chunk(SH.local(t), _split(mesh, dims, 0),
                                      mesh)
            if path in layout.gathered:
                whole[path] = SH.to_placements(
                    t, SH.keep_chunk(t.placements, mdim))
                return whole[path]
            return SH.local(t)

        local = unflatten_like(state, [mine(path, t)
                                       for path, t in flatten(state)])
        with SH.data_parallel(mesh, dims), \
                SH.model_parallel(mesh, mdim), SH.kv_split(split):
            logits, _ = T.decode_step(cfg, model, local, SH.local(tokens))
        for path, t in flatten(state):
            if path in whole:  # this rank's chunk along "model"
                along = _split(mesh, (mdim,), t.placements[mdim].dim)
                SH.local(t).copy_(SH.local_chunk(whole[path], along, mesh))
        SH.local(state["pos"]).add_(1)
        placements = list(_split(mesh, dims, 0))
        vocab = cfg.padded_vocab()
        if logits.shape[-1] != vocab:  # this rank's vocab chunk
            from torch.distributed.tensor import Shard
            placements[mdim] = Shard(1)
        return (SH.from_local(logits, mesh, tuple(placements),
                              (shape.global_batch, vocab)), state)

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
