"""Logical-axis sharding engine of the port, on a ``DeviceMesh``.

Counterpart of the JAX package's ``parallel/sharding.py``. Model code
annotates parameters with *logical* axis names ("batch", "heads", "ffn",
...); a ``ShardingRules`` table maps logical names to mesh axes, and the
offload genome mutates that table. A spec is a tuple with one entry a
tensor dim (None, a mesh-axis name, or a tuple of names), equal entry for
entry to the reference's ``PartitionSpec``; ``_prune_spec_for`` keeps the
reference's rules (an axis that does not divide the dim is dropped, and an
axis already claimed by an earlier dim is dropped: first use wins).

A "sharding" (``NamedSharding``) is a mesh and a pruned spec; its
``placements`` are the DTensor placements the spec gives, one a mesh dim:
``Shard(d)`` where the spec puts that mesh axis on dim d, ``Replicate()``
elsewhere. A dim sharded over several mesh axes is split in the mesh's dim
order (the first axis major), as JAX splits ``("pod", "data")``; a spec
that names them in another order raises, since plain ``Shard`` placements
cannot express it.

The mesh step builders (``launch/steps.py``) keep the train state laid out
by these shardings, each rank holding its shard as a ``DTensor``, and
compute on plain local tensors: the kernels read ``data_ptr()``, so no
``DTensor`` reaches them. ``LayerShards`` is one unit of the model's layer
loops over this rank's shards: its ``gather`` all-gathers the unit's
leaves whole (but for the model chunk a leaf keeps, ``roles``), and its
backward reduces their gradients into the shards (``reduce_leaf``), the
counterpart of the reference's
``_constrain_layer_params``; ``GATHER`` counts what it did. ``local``,
``to_placements`` and ``from_placements`` move a tensor between its layout
and the layout a step computes in; ``reduce_over`` makes a reduction taken
on a shard global over the mesh dims that shard it (the global norm, the
compression scale, Adafactor's means); ``data_parallel`` tells the loss,
the MoE router and the gather's backward which mesh dims split the batch,
so that their batch means and gradient sums are global.

``model_parallel`` opens the model-parallel region of a step: the blocks
whose unit kept this rank's chunk of heads, ffn columns, vocab rows or
SSM/RWKV heads (``LayerShards``' roles) compute that chunk, between
``enter`` (Megatron's ``f``: the identity, its backward an all-reduce over
"model") and ``leave`` (``g``: an all-reduce, its backward the identity);
``model_sum`` all-reduces both ways, ``model_max`` takes a max with no
gradient. Given the rules, the region also splits a train or prefill
step's residual stream along its sequence over "model" where the rules
put ``seq`` there and the pruned spec keeps it for the stream's own length
(Megatron-SP, ``seq_parallel``, ``seq_split_for``): the norms and the
residual adds then run on this rank's rows, ``enter`` all-gathers the
sequence (its backward a reduce-scatter into this rank's rows) and
``leave`` reduce-scatters the partial outputs into them (its backward an
all-gather); a block with no split leaf gathers its input the same way and
takes its own rows of its whole output. A prefill's region (``inner``)
also keeps the blocks' inner sequence on "model" where the rules put
``seq_inner`` there and the pruned specs keep it (``seq_inner_for``, the
reference's first-use claim, which leaves the heads, ffn and vocab
whole): attention then runs this rank's query rows against K and V
all-gathered along the sequence (``seq_gather``), and the MLP and the head
compute on the rows with no sequence collective (``SeqSplit.inner``). ``kv_split`` tells decode
attention which shard of the caches' sequence (``kv_seq``) this rank
holds, and over which ranks its softmax statistics and partial outputs
are reduced (flash-decode: ``KvSplit``, made by ``kv_split_over``).
``MODEL`` counts the collectives of all three. On a model group of one
rank each is the identity and launches nothing, and a sequence kept whole
opens no split.

When no mesh is active every annotation is a no-op, as in the reference.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import Any, Optional, Union

import torch

from repro_torch._tree import leaves, unflatten_like

Axis = Union[None, str, tuple[str, ...]]

# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

# Default logical->mesh mapping for the production mesh ("data", "model") or
# ("pod", "data", "model"), the reference's table.
DEFAULT_RULES: dict[str, Axis] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,              # residual-stream seq; "model" = Megatron-SP
    "seq_inner": None,        # seq INSIDE blocks (TP on heads/ffn wins there)
    "embed": None,
    "act_heads": "model",
    "act_kv_heads": None,
    "act_ffn": "model",
    "act_vocab": "model",
    "kv_seq": "model",        # decode: KV cache sequence-sharded (flash-decode)
    "kv_batch": ("pod", "data"),  # cache batch dim (decoupled from act batch)
    "act_experts": None,
    "expert_cap": None,
    # parameters (fsdp = ZeRO-3 axis, tensor = TP axis)
    "fsdp": ("pod", "data"),
    "heads": "model",
    "kv_heads": None,
    "ffn": "model",
    "vocab": "model",
    "experts": None,
    "expert_ffn": "model",
    "ssm_heads": "model",
    "ssm_inner": "model",
    "rwkv_heads": "model",
    "layers": None,
    "stage": None,            # pipeline axis when PP enabled ("pod")
    "unsharded": None,
}


@dataclass(frozen=True)
class ShardingRules:
    mapping: dict[str, Axis] = field(default_factory=lambda: dict(DEFAULT_RULES))
    # light=True keeps only *essential* activation constraints
    light: bool = False

    def with_overrides(self, **overrides: Axis) -> "ShardingRules":
        m = dict(self.mapping)
        light = bool(overrides.pop("light", self.light))
        m.update(overrides)
        return ShardingRules(m, light)

    def axis(self, logical: Optional[str]) -> Axis:
        if logical is None:
            return None
        if logical not in self.mapping:
            raise KeyError(f"unknown logical axis {logical!r}")
        return self.mapping[logical]

    def spec(self, logical_axes: tuple[Optional[str], ...]) -> tuple:
        return tuple(self.axis(a) for a in logical_axes)


# ---------------------------------------------------------------------------
# Active context (mesh, rules, the data-parallel split), per thread
# ---------------------------------------------------------------------------


class _Ctx(threading.local):
    def __init__(self) -> None:
        self.mesh = None
        self.rules: Optional[ShardingRules] = None
        self.batch_mesh = None
        self.batch_dims: tuple[int, ...] = ()
        self.model_mesh = None
        self.model_dim: Optional[int] = None
        self.seq_rules: Optional[ShardingRules] = None
        self.inner = False
        self.seq: Optional["SeqSplit"] = None
        self.kv: Optional["KvSplit"] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[ShardingRules] = None):
    """Activate (mesh, rules) for sharding annotations."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


_FIELDS = ("mesh", "rules", "batch_mesh", "batch_dims", "model_mesh",
           "model_dim", "seq_rules", "inner", "seq", "kv")


def current_context() -> tuple:
    """This thread's whole context (mesh, rules, the data-parallel split,
    the model-parallel region and its sequence split, the caches'
    sequence split), for ``in_context``."""
    return tuple(getattr(_CTX, k) for k in _FIELDS)


@contextlib.contextmanager
def in_context(context: tuple):
    """Within: ``context`` (``current_context()``, taken perhaps on another
    thread) is this thread's. Remat's recompute runs in the backward, on
    the autograd engine's thread for a card's tensors, where the forward's
    context is not set: the recomputed function re-enters it so."""
    prev = current_context()
    for k, v in zip(_FIELDS, context):
        setattr(_CTX, k, v)
    try:
        yield
    finally:
        for k, v in zip(_FIELDS, prev):
            setattr(_CTX, k, v)


def current_mesh():
    return _CTX.mesh


def current_rules() -> Optional[ShardingRules]:
    return _CTX.rules


def _mesh_axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or of the reference tests'
    stand-in (``axis_names`` and ``devices.shape``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _prune_spec_for(shape: tuple[int, ...], spec: tuple, mesh) -> tuple:
    """Drop mesh axes whose size does not divide the dim (replicate instead)
    and axes already claimed by an earlier dim (first use wins)."""
    sizes = _mesh_axis_sizes(mesh)
    used: set[str] = set()
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        axes = tuple(a for a in axes if a in sizes and a not in used)
        total = 1
        kept: list[str] = []
        for a in axes:
            if dim % (total * sizes[a]) == 0:
                kept.append(a)
                total *= sizes[a]
        used.update(kept)
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return tuple(out)


def placements_for(spec: tuple, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one a mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {spec}: mesh {names} has no axis "
                             f"{missing[0]!r}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec}: dim {d} is split over {axes}, but a DTensor "
                f"splits a dim over mesh axes in the mesh's order {names}")
        for k in idx:
            if not isinstance(out[k], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[k]!r} "
                                 f"shards two dims")
            out[k] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec on it (pruned where a shape was known)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)


def named_sharding(mesh, rules: ShardingRules,
                   logical_axes: tuple[Optional[str], ...],
                   shape: Optional[tuple[int, ...]] = None) -> NamedSharding:
    spec = rules.spec(logical_axes)
    if shape is not None:
        spec = _prune_spec_for(shape, spec, mesh)
    return NamedSharding(mesh, spec)


def shard_act(x, logical_axes: tuple[Optional[str], ...],
              essential: bool = False):
    """Lay an activation out by its logical axes: a DTensor is
    redistributed to the pruned spec's placements; a plain tensor (the
    local shard a mesh step computes on) and anything without a mesh are
    returned as they are. ``rules.light`` skips all but essential ones."""
    from torch.distributed.tensor import DTensor

    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or rules is None or not isinstance(x, DTensor):
        return x
    if rules.light and not essential:
        return x
    spec = _prune_spec_for(tuple(x.shape), rules.spec(logical_axes), mesh)
    return x.redistribute(mesh, placements_for(spec, mesh))


# ---------------------------------------------------------------------------
# Parameter definitions -> init / sharding specs  (single source of truth)
# ---------------------------------------------------------------------------


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


def map_defs(fn, defs: Any) -> Any:
    """``fn`` over every PDef of a tree of dicts."""
    if isinstance(defs, PDef):
        return fn(defs)
    return {k: map_defs(fn, v) for k, v in defs.items()}


def stack_defs(defs: Any, num: int) -> Any:
    """Add a leading stacked-layers axis to every PDef in a tree."""
    return map_defs(lambda d: PDef((num,) + d.shape, ("layers",) + d.axes,
                                   d.init, d.scale, d.dtype), defs)


# f32 elements of one random draw, at most: a larger leaf is drawn and cast
# a block of leading-axis slices at a time (one slice, if a slice is larger)
DRAW_ELEMENTS = 1 << 28


def init_from_defs(generator: torch.Generator, defs: Any,
                   dtype: torch.dtype) -> Any:
    """Materialize parameters from defs on the generator's device, by the
    reference's rule: zeros and ones; otherwise f32 normal draws times
    ``scale`` (``init="normal"``) or 1/sqrt(fan_in) with fan_in =
    ``shape[-2]``, cast to the leaf's dtype. The numbers are not JAX's:
    tests that compare the two packages carry weights across instead.

    A leaf is drawn into a tensor of its own dtype in blocks of leading-axis
    slices of at most ``DRAW_ELEMENTS`` f32 values (one slice where a slice
    is larger), so the f32 draw beside the model is never larger than one
    block: one layer of mixtral-8x7b's stacked experts (1.88 GB) rather
    than the whole stack."""
    device = generator.device

    def one(d: PDef) -> torch.Tensor:
        dt = d.dtype or dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale if d.init == "normal" else 1.0 / (fan_in ** 0.5)
        out = torch.empty(d.shape, dtype=dt, device=device)
        step = max(1, DRAW_ELEMENTS // max(out[0].numel(), 1))
        for i in range(0, d.shape[0], step):
            block = out[i:i + step]
            draw = torch.randn(block.shape, generator=generator,
                               dtype=torch.float32, device=device)
            block.copy_(draw.mul_(std))
        return out

    return map_defs(one, defs)


def specs_from_defs(defs: Any, rules: ShardingRules, mesh=None) -> Any:
    def one(d: PDef):
        spec = rules.spec(d.axes)
        if mesh is not None:
            spec = _prune_spec_for(d.shape, spec, mesh)
        return spec

    return map_defs(one, defs)


def shardings_from_defs(defs: Any, rules: ShardingRules, mesh) -> Any:
    return map_defs(lambda d: NamedSharding(
        mesh, _prune_spec_for(d.shape, rules.spec(d.axes), mesh)), defs)


# ---------------------------------------------------------------------------
# Shards: a tensor's local part, layouts, and global reductions
# ---------------------------------------------------------------------------


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t):
    """The rank's local part of a DTensor (its storage: writing it writes
    the DTensor), or the tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def _effective(placements: tuple, mesh) -> tuple:
    """Placements with those on mesh dims of size 1 read as Replicate: a
    shard over one rank is the whole."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if mesh.size(k) == 1 else p
                 for k, p in enumerate(placements))


def local_chunk(full: torch.Tensor, placements: tuple, mesh) -> torch.Tensor:
    """This rank's part of ``full`` under ``placements`` (a view)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    out = full
    for k, p in enumerate(placements):
        n = mesh.size(k)
        if isinstance(p, Shard) and n > 1:
            if out.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(full.shape)} does "
                                 f"not split over {n} ranks")
            size = out.shape[p.dim] // n
            out = out.narrow(p.dim, coord[k] * size, size)
    return out


def memory_key(t: torch.Tensor):
    """Where ``t``'s data starts: its data pointer; for a fake tensor (the
    dry run's, which has no data) its storage and offset, unique while
    the storage lives."""
    if type(t) is torch.Tensor:  # the card's and the CPU's: no import
        return t.data_ptr()
    from torch._subclasses.fake_tensor import FakeTensor

    if isinstance(t, FakeTensor):
        return (t.untyped_storage()._cdata, t.storage_offset())
    return t.data_ptr()


def from_local(part: torch.Tensor, mesh, placements: tuple, shape):
    """The DTensor of global ``shape`` (contiguous) laid out by
    ``placements`` whose local part on this rank is ``part``."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    return DTensor.from_local(
        part, mesh, placements, run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def distribute(full: torch.Tensor, sharding: NamedSharding):
    """``full`` (the same on every rank) as a DTensor laid out by
    ``sharding``: each rank keeps its chunk, with no communication. On a
    mesh of one rank the DTensor's storage is ``full``'s."""
    mesh, placements = sharding.mesh, sharding.placements
    return from_local(local_chunk(full, placements, mesh).contiguous(), mesh,
                      placements, full.shape)


def to_placements(t, placements: tuple) -> torch.Tensor:
    """The local part of DTensor ``t`` laid out by ``placements``: ``t``'s
    own storage when the two differ only on mesh dims of size 1, else a
    redistributed copy (all-gathers where a dim is gathered)."""
    mesh = t.device_mesh
    if _effective(t.placements, mesh) == _effective(placements, mesh):
        return t.to_local()
    return t.redistribute(mesh, placements).to_local()


def from_placements(part: torch.Tensor, mesh, src: tuple, dst: tuple,
                    shape) -> torch.Tensor:
    """``part``, a local part under ``src`` of a tensor of global
    ``shape``, as the local part under ``dst``: ``part`` itself when the
    two differ only on mesh dims of size 1."""
    if _effective(src, mesh) == _effective(dst, mesh):
        return part
    return from_local(part, mesh, src, shape).redistribute(mesh,
                                                           dst).to_local()


def full(t) -> torch.Tensor:
    """The whole of a DTensor on every rank (``t``'s storage on a mesh of
    one rank), or the tensor itself."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    return to_placements(t, (Replicate(),) * t.device_mesh.ndim)


def shard_mesh_dims(t, dims: Optional[tuple[int, ...]] = None) -> list[int]:
    """The mesh dims of more than one rank that shard DTensor ``t`` along
    its tensor dims ``dims`` (negative counts from the end; None: any);
    ``[]`` for a plain tensor."""
    if not is_dtensor(t):
        return []
    from torch.distributed.tensor import Shard

    mesh = t.device_mesh
    want = None if dims is None else {d % t.dim() for d in dims}
    return [k for k, p in enumerate(t.placements)
            if isinstance(p, Shard) and mesh.size(k) > 1
            and (want is None or p.dim in want)]


def reduce_over(value: torch.Tensor, t, dims: Optional[tuple[int, ...]] = None,
                op: str = "sum") -> torch.Tensor:
    """All-reduce ``value``, computed from DTensor ``t``'s local part, in
    place over the mesh dims that shard ``t`` along ``dims`` (None: any
    dim), so that a sum or max over those dims is global. A plain tensor,
    or one sharded only over mesh dims of one rank, is left as it is."""
    import torch.distributed as dist

    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    for k in shard_mesh_dims(t, dims):
        dist.all_reduce(value, op=red, group=t.device_mesh.get_group(k))
    return value


# ---------------------------------------------------------------------------
# The data-parallel split of a step's batch
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def data_parallel(mesh, dims: tuple[int, ...]):
    """Within: the batch a step computes on is this rank's share of the
    batch split over mesh dims ``dims``. ``batch_sum`` then sums over
    them, so that the loss's and the router's batch means are global."""
    prev = (_CTX.batch_mesh, _CTX.batch_dims)
    _CTX.batch_mesh = mesh
    _CTX.batch_dims = tuple(k for k in dims if mesh.size(k) > 1)
    try:
        yield
    finally:
        _CTX.batch_mesh, _CTX.batch_dims = prev


def batch_shards() -> int:
    """How many shares the active data-parallel split makes (1 without)."""
    mesh = _CTX.batch_mesh
    return math.prod(mesh.size(k) for k in _CTX.batch_dims) if mesh else 1


def batch_sum(value: torch.Tensor) -> torch.Tensor:
    """``value`` summed over the active data-parallel split (in place; no
    gradient flows through the sum), or ``value`` itself without one."""
    import torch.distributed as dist

    for k in _CTX.batch_dims:
        dist.all_reduce(value, group=_CTX.batch_mesh.get_group(k))
    return value


def model_dim_of(mesh) -> Optional[int]:
    """The index of ``mesh``'s "model" dim, or None."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    return names.index("model") if "model" in names else None


# ---------------------------------------------------------------------------
# The model-parallel region: heads, ffn, vocab split over "model"
# ---------------------------------------------------------------------------


@dataclass
class _Counts:
    """Counters under a lock (``add``, ``counts``, ``reset``), named by
    ``COUNTS``."""
    lock: Any = field(default_factory=threading.Lock, repr=False)

    COUNTS = ()

    def add(self, name: str, n: int = 1) -> None:
        with self.lock:
            setattr(self, name, getattr(self, name) + n)

    def counts(self) -> dict:
        with self.lock:
            return {k: getattr(self, k) for k in self.COUNTS}

    def reset(self) -> None:
        with self.lock:
            for k in self.COUNTS:
                setattr(self, k, 0)


@dataclass
class ModelStats(_Counts):
    """The model-parallel region's collectives over "model" since
    ``reset``: ``all_reduces`` (``leave``'s and ``model_sum``'s forward,
    ``enter``'s and ``model_sum``'s backward, ``model_max``, and a
    ``KvSplit``'s reductions over the caches' sequence shards) and the
    ``bytes`` they reduced; under a sequence split (``seq_parallel``), the
    ``all_gathers`` of the sequence (``enter``'s forward, ``leave``'s
    backward) and the ``reduce_scatters`` into this rank's rows
    (``leave``'s forward, ``enter``'s backward), with ``gathered_bytes``
    and ``scattered_bytes``, the bytes of the whole sequence each one
    gathered or scattered."""
    all_reduces: int = 0
    bytes: int = 0
    all_gathers: int = 0
    gathered_bytes: int = 0
    reduce_scatters: int = 0
    scattered_bytes: int = 0

    COUNTS = ("all_reduces", "bytes", "all_gathers", "gathered_bytes",
              "reduce_scatters", "scattered_bytes")


MODEL = ModelStats()


@contextlib.contextmanager
def model_parallel(mesh, dim: Optional[int],
                   rules: Optional[ShardingRules] = None,
                   inner: bool = False):
    """Within: the blocks compute this rank's chunk of every leaf that its
    unit kept split over mesh dim ``dim`` ("model"), ``enter``, ``leave``,
    ``model_sum`` and ``model_max`` reducing over that dim's group; with
    ``rules``, ``seq_parallel`` splits a residual stream along its
    sequence where they say so, and, with ``inner`` (a prefill step: the
    rules set ``seq_inner`` for prefill alone), the blocks' inner sequence
    where they say so (``seq_inner_for``). A dim of one rank (or None)
    opens no region: each is then the identity."""
    prev = (_CTX.model_mesh, _CTX.model_dim, _CTX.seq_rules, _CTX.inner,
            _CTX.seq)
    live = dim is not None and mesh.size(dim) > 1
    _CTX.model_mesh = mesh if live else None
    _CTX.model_dim = dim if live else None
    _CTX.seq_rules = rules if live else None
    _CTX.inner = inner and live
    _CTX.seq = None
    try:
        yield
    finally:
        (_CTX.model_mesh, _CTX.model_dim, _CTX.seq_rules, _CTX.inner,
         _CTX.seq) = prev


def model_index() -> int:
    """This rank's place along the active region's "model" dim (0
    without): its chunk of a split leaf is chunk ``model_index()``."""
    mesh = _CTX.model_mesh
    return mesh.get_coordinate()[_CTX.model_dim] if mesh is not None else 0


def _model_all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    """A contiguous copy of ``t`` all-reduced over ``group``."""
    import torch.distributed as dist

    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    MODEL.add("all_reduces")
    MODEL.add("bytes", out.nbytes)
    return out


class _Enter(torch.autograd.Function):
    """Megatron's ``f``: the identity; the backward sums the model ranks'
    partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        return _model_all_reduce(g, ctx.group, dist.ReduceOp.SUM), None


class _Leave(torch.autograd.Function):
    """Megatron's ``g``: the sum of the model ranks' partial outputs; the
    backward is the identity (each rank's gradient is already whole)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        return _model_all_reduce(x, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Sum(torch.autograd.Function):
    """An all-reduce whose backward is an all-reduce: a sum of the model
    ranks' parts that every rank then reads, as ``_gated_norm``'s squares,
    whose gradient arrives partial on each rank."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        return _model_all_reduce(x, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        return _model_all_reduce(g, ctx.group, dist.ReduceOp.SUM), None


def _model_group():
    return _CTX.model_mesh.get_group(_CTX.model_dim)


# ---------------------------------------------------------------------------
# Megatron-SP: the residual stream's sequence split over "model"
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SeqSplit:
    """A residual stream split along its sequence (dim 1) over the model
    group ``group`` of ``count`` ranks: this rank holds chunk ``index``,
    rows ``[index·S/count, (index+1)·S/count)`` of a sequence of S.
    ``inner``: the blocks keep those rows inside too (prefill's
    ``seq_inner``, ``seq_inner_for``)."""
    index: int
    count: int
    group: Any
    inner: bool = False

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``t`` (the whole sequence along dim 1),
        contiguous; their gradient is zero elsewhere."""
        n = t.shape[1] // self.count
        return t.narrow(1, self.index * n, n).contiguous()


def _seq_axes(shape: tuple[int, ...], rules: ShardingRules,
              mesh) -> tuple[str, ...]:
    """The mesh axes of more than one rank that split the sequence of an
    activation of global ``shape`` (batch, sequence, ...): the rules'
    ``("batch", "seq", "embed")`` spec pruned for ``shape``
    (``_prune_spec_for``, the reference's per-activation rule)."""
    entry = _prune_spec_for(tuple(shape),
                            rules.spec(("batch", "seq", "embed")), mesh)[1]
    sizes = _mesh_axis_sizes(mesh)
    return tuple(a for a in (entry if isinstance(entry, tuple)
                             else (entry,))
                 if a is not None and sizes[a] > 1)


def seq_split_for(shape: tuple[int, ...], rules: ShardingRules,
                  mesh) -> bool:
    """Whether an activation of global ``shape`` (batch, sequence, ...)
    splits its sequence over "model" (``_seq_axes``)."""
    return "model" in _seq_axes(shape, rules, mesh)


def _inner_axes(shape: tuple[int, ...], rules: ShardingRules,
                mesh) -> tuple[str, ...]:
    """The mesh axes of more than one rank that the reference's
    ``shard_act`` points naming ``seq_inner`` keep on the sequence of an
    activation of global ``shape`` (batch, sequence, ...): attention's q,
    K, V and output, the MLP's hidden, RWKV's and Mamba2's heads, the
    head's logits, each ``("batch", "seq_inner", ...)`` pruned for its
    shape (``_prune_spec_for``). Their batch and sequence dims are the
    stream's, and the pruning claims axes dim by dim, so the stream's
    ``(batch, sequence)`` decides for all of them; an axis the sequence
    keeps is gone from the heads, ffn or vocab after it (first use
    wins)."""
    entry = _prune_spec_for(tuple(shape[:2]),
                            rules.spec(("batch", "seq_inner")), mesh)[1]
    sizes = _mesh_axis_sizes(mesh)
    return tuple(a for a in (entry if isinstance(entry, tuple)
                             else (entry,))
                 if a is not None and sizes[a] > 1)


def seq_inner_for(shape: tuple[int, ...], rules: ShardingRules,
                  mesh) -> bool:
    """Whether a prefill's blocks inside a stream of global ``shape``
    (batch, sequence, ...) keep its sequence on "model" (``_inner_axes``):
    attention over this rank's query rows, the MLP and the head on its
    rows, their heads, ffn and vocab whole. Raises for what the port does
    not take: the inner sequence over another axis, or on "model" where
    the residual stream's is not (``seq_split_for``), a layout that the
    reference's ``rules_for`` never makes (only its ``overrides`` can)."""
    axes = _inner_axes(shape, rules, mesh)
    if not axes:
        return False
    if axes != ("model",):
        raise NotImplementedError(f"seq_inner over {axes}: the port splits "
                                  f"it over 'model' alone")
    if not seq_split_for(shape, rules, mesh):
        raise ValueError(
            f"seq_inner on 'model' for a stream of {tuple(shape)} whose "
            f"residual stream's seq is not ({rules.axis('seq')!r}): a "
            f"layout the reference's rules_for never makes")
    return True


@contextlib.contextmanager
def seq_parallel(shape: tuple[int, ...]):
    """Within: the residual stream, of ``shape`` (this rank's batch rows,
    the whole sequence's length, the width), is this rank's rows of its
    sequence split over "model" where the region was opened with rules
    that say so for the stream's global shape (``seq_split_for``, the
    batch counted over the data-parallel split): Megatron-SP. ``enter``
    and ``leave`` then gather and scatter its sequence. Yields the
    ``SeqSplit``, or None (no region, no rules, or a sequence kept
    whole): the stream is then whole on every rank, and every op is the
    unsplit region's. In a prefill's region the split's ``inner`` says
    whether the blocks keep the rows inside too (``seq_inner_for``)."""
    prev = _CTX.seq
    split = None
    mesh, rules = _CTX.model_mesh, _CTX.seq_rules
    if mesh is not None and rules is not None:
        whole = (shape[0] * batch_shards(),) + tuple(shape[1:])
        axes = _seq_axes(whole, rules, mesh)
        if axes and axes != ("model",):
            raise NotImplementedError(f"a sequence split over {axes}: the "
                                      f"port splits it over 'model' alone")
        inner = _CTX.inner and seq_inner_for(whole, rules, mesh)
        if axes:
            split = SeqSplit(model_index(), mesh.size(_CTX.model_dim),
                             _model_group(), inner)
    _CTX.seq = split
    try:
        yield split
    finally:
        _CTX.seq = prev


def current_seq_split() -> Optional[SeqSplit]:
    """The active residual stream's sequence split, or None."""
    return _CTX.seq


def _seq_all_gather(x: torch.Tensor, sp: SeqSplit) -> torch.Tensor:
    """The model ranks' rows of ``x`` joined along dim 1, in rank order."""
    import torch.distributed as dist

    part = x.movedim(1, 0).contiguous()
    out = torch.empty((sp.count * part.shape[0],) + part.shape[1:],
                      dtype=part.dtype, device=part.device)
    dist.all_gather_into_tensor(out, part, group=sp.group)
    MODEL.add("all_gathers")
    MODEL.add("gathered_bytes", out.nbytes)
    return out.movedim(0, 1).contiguous()


def _seq_reduce_scatter(x: torch.Tensor, sp: SeqSplit) -> torch.Tensor:
    """This rank's rows (along dim 1) of the sum of the model ranks'
    ``x``."""
    import torch.distributed as dist

    whole = x.movedim(1, 0).contiguous()
    out = torch.empty((whole.shape[0] // sp.count,) + whole.shape[1:],
                      dtype=whole.dtype, device=whole.device)
    dist.reduce_scatter_tensor(out, whole, group=sp.group)
    MODEL.add("reduce_scatters")
    MODEL.add("scattered_bytes", whole.nbytes)
    return out.movedim(0, 1).contiguous()


def _own_rows(x: torch.Tensor, sp: SeqSplit) -> torch.Tensor:
    """This rank's rows of ``x``, in storage of their own."""
    rows = sp.rows(x)
    return rows.clone() if rows._is_view() else rows


class _SeqEnter(torch.autograd.Function):
    """Megatron-SP's ``g``: this rank's rows all-gathered along the
    sequence. The backward reduce-scatters the model ranks' partial
    gradients into this rank's rows where the block computes a model split
    (``split``), and takes this rank's rows of the gradient where not:
    every model rank then computed the whole of it."""

    @staticmethod
    def forward(ctx, x, sp, split):
        ctx.sp, ctx.split = sp, split
        return _seq_all_gather(x, sp)

    @staticmethod
    def backward(ctx, g):
        sp = ctx.sp
        return (_seq_reduce_scatter(g, sp) if ctx.split
                else _own_rows(g, sp)), None, None


class _SeqLeave(torch.autograd.Function):
    """Megatron-SP's ``ḡ``: the model ranks' partial outputs summed into
    this rank's rows by a reduce-scatter where the block computes a model
    split (``split``), this rank's rows of the output where not; the
    backward all-gathers the rows' gradient, whole on every rank."""

    @staticmethod
    def forward(ctx, x, sp, split):
        ctx.sp = sp
        return _seq_reduce_scatter(x, sp) if split else _own_rows(x, sp)

    @staticmethod
    def backward(ctx, g):
        return _seq_all_gather(g, ctx.sp), None, None


class _Once(torch.autograd.Function):
    """The identity; the backward keeps the gradient on the first model
    rank and gives the others zeros."""

    @staticmethod
    def forward(ctx, x, first):
        ctx.first = first
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


def enter(x: torch.Tensor, split: bool = True,
          rows: Optional[bool] = None) -> torch.Tensor:
    """A block's input ``x`` into the region; ``split``: the block
    computes a model split (a kept chunk), so its output is partial over
    the model ranks. Without a sequence split: where ``split``, the
    identity whose backward all-reduces the gradient over "model"
    (Megatron's ``f``), else ``x`` itself. Under ``seq_parallel``'s split
    ``x`` is this rank's rows and comes out whole along the sequence, an
    all-gather (``_SeqEnter``) whatever ``split`` says; ``rows`` False
    says ``x`` is whole there all the same (an encoder's memory whose
    own length did not split), None that it is the stream's."""
    sp = _CTX.seq if rows is None or rows else None
    if sp is not None:
        return _SeqEnter.apply(x, sp, split)
    if _CTX.model_mesh is None or not split:
        return x
    return _Enter.apply(x, _model_group())


def leave(x: torch.Tensor, split: bool = True) -> torch.Tensor:
    """A block's output ``x`` out of the region; ``split`` as for
    ``enter``. Without a sequence split: where ``split``, the model ranks'
    partial ``x`` summed, an all-reduce whose backward is the identity
    (Megatron's ``g``), else ``x`` itself. Not
    ``torch.distributed.nn.functional.all_reduce``: its backward
    all-reduces again, which would multiply by the model size a gradient
    that every rank already holds whole. Under ``seq_parallel``'s split
    the output comes out as this rank's rows: a reduce-scatter of the
    partial sums where ``split``, this rank's rows of the whole where not
    (``_SeqLeave``; a reduce-scatter there would multiply it by the model
    size)."""
    sp = _CTX.seq
    if sp is not None:
        return _SeqLeave.apply(x, sp, split)
    if _CTX.model_mesh is None or not split:
        return x
    return _Leave.apply(x, _model_group())


def on_rows(split: bool) -> bool:
    """Whether a block with whole leaves (``split`` False) computes on this
    rank's rows of the stream as they are, with no ``enter`` or ``leave``:
    prefill's ``seq_inner`` (``SeqSplit.inner``). Attention then gathers
    its K and V (``seq_gather``)."""
    sp = _CTX.seq
    return sp is not None and sp.inner and not split


def seq_gather(x: torch.Tensor) -> torch.Tensor:
    """Under a sequence split, the model ranks' rows of ``x`` joined along
    dim 1 in rank order (an all-gather; its backward reduce-scatters the
    ranks' partial gradients into this rank's rows): attention's K and V
    under ``seq_inner``, which every rank's query rows read whole. ``x``
    itself without a split."""
    sp = _CTX.seq
    return x if sp is None else _SeqEnter.apply(x, sp, True)


def once(x: torch.Tensor) -> torch.Tensor:
    """``x``, the same on every model rank, whose gradient (the same on
    every rank) only the first model rank keeps, so that a sum of the
    ranks' gradients counts it once: the MoE aux loss under a sequence
    split, whose router reads a gathered stream whose gradient is summed
    by ``enter``'s reduce-scatter. ``x`` itself outside a region."""
    if _CTX.model_mesh is None:
        return x
    return _Once.apply(x, model_index() == 0)


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model ranks, with an all-reduce both ways."""
    return x if _CTX.model_mesh is None else _Sum.apply(x, _model_group())


def model_max(x: torch.Tensor) -> torch.Tensor:
    """The max of ``x`` over the model ranks, with no gradient."""
    if _CTX.model_mesh is None:
        return x
    import torch.distributed as dist

    return _model_all_reduce(x.detach(), _model_group(), dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# Flash-decode: the caches' sequence split over mesh dims ("kv_seq")
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KvSplit:
    """This rank's part of the decode caches split along their sequence:
    shard ``index`` of ``count`` (rows ``[index·T/count, (index+1)·T/count)``
    of a cache of T rows), and ``reduce(x, op)``, ``x`` all-reduced
    (``op`` "max" or "sum") over the ranks that hold the other shards.
    Decode runs under ``no_grad``: the reductions carry no gradient."""
    index: int
    count: int
    reduce: Any


@contextlib.contextmanager
def kv_split(split: Optional[KvSplit]):
    """Within: decode attention reads this rank's shard of the caches'
    sequence as ``split`` says (None: the whole)."""
    prev = _CTX.kv
    _CTX.kv = split
    try:
        yield
    finally:
        _CTX.kv = prev


def current_kv_split() -> Optional[KvSplit]:
    return _CTX.kv


def mesh_group(mesh, dims: tuple[int, ...]):
    """The process group of this rank's ranks along mesh ``dims`` (sorted;
    ranks in the mesh's order, the first dim major, as ``local_chunk``
    splits): a dim's own group for one dim; for several, a ``new_group``
    made once per mesh and dims (every rank of the mesh makes every such
    group, in one order) and kept on the mesh."""
    import torch.distributed as dist

    dims = tuple(sorted(dims))
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    made = mesh.__dict__.setdefault("_kv_groups", {})
    if dims not in made:
        ranks = mesh.mesh.movedim(dims, tuple(range(mesh.ndim - len(dims),
                                                    mesh.ndim)))
        ranks = ranks.reshape(-1, math.prod(mesh.size(k) for k in dims))
        me = dist.get_rank()
        for row in ranks.tolist():
            group = dist.new_group(ranks=row)
            if me in row:
                made[dims] = group
    return made[dims]


def _kv_reduce(group, x: torch.Tensor, op: str) -> torch.Tensor:
    import torch.distributed as dist

    return _model_all_reduce(
        x, group, dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)


def kv_split_over(mesh, dims: tuple[int, ...]) -> Optional[KvSplit]:
    """The split of a cache whose sequence is sharded over mesh ``dims``
    (None where they hold one rank): this rank's shard, the first dim
    major, and all-reduces over their group (``mesh_group``), counted in
    ``MODEL``."""
    import functools

    dims = tuple(sorted(k for k in dims if mesh.size(k) > 1))
    if not dims:
        return None
    coord = mesh.get_coordinate()
    index = 0
    for k in dims:
        index = index * mesh.size(k) + coord[k]
    return KvSplit(index, math.prod(mesh.size(k) for k in dims),
                   functools.partial(_kv_reduce, mesh_group(mesh, dims)))


def like(part: torch.Tensor, t):
    """``part``, a local part in DTensor ``t``'s layout, as a DTensor of
    ``t``'s layout; ``part`` itself when ``t`` is a plain tensor."""
    if not is_dtensor(t):
        return part
    return from_local(part, t.device_mesh, t.placements, t.shape)


def assign(tree: dict, key, value: torch.Tensor) -> None:
    """``tree[key] = value``; into the local part of a DTensor leaf in
    place, so that the leaf keeps its layout."""
    if is_dtensor(tree[key]):
        tree[key].to_local().copy_(value)
    else:
        tree[key] = value


def mean_over(x: torch.Tensor, t, dim: Optional[int] = None,
              keepdim: bool = False) -> torch.Tensor:
    """The mean of ``x``, computed on DTensor ``t``'s local part (or of a
    tensor of ``t``'s local shape), along tensor dim ``dim`` (None: every
    dim), global over the mesh dims that shard ``t`` there. Without such
    a mesh dim, ``torch.mean`` itself."""
    dims = None if dim is None else (dim,)
    if not shard_mesh_dims(t, dims):
        return (torch.mean(x) if dim is None
                else torch.mean(x, dim, keepdim=keepdim))
    if dim is None:
        return reduce_over(torch.sum(x), t) / t.numel()
    return reduce_over(torch.sum(x, dim, keepdim=keepdim), t,
                       dims) / t.shape[dim]


# ---------------------------------------------------------------------------
# A unit of the layer loops gathered whole, its gradient reduced into shards
# ---------------------------------------------------------------------------


@dataclass
class GatherStats(_Counts):
    """What ``LayerShards.gather`` did since ``reset``: ``calls`` units
    gathered, ``bytes_copied`` the bytes of the whole leaves it made (0
    where every shard is the whole), ``all_gathers`` its collectives;
    ``reductions`` units whose gradient its backward reduced into the
    shards, by ``reduce_scatters`` and ``all_reduces``. ``watch``, if set,
    is called with every whole leaf a gather returns through the
    collectives' path (a test's spy)."""
    calls: int = 0
    bytes_copied: int = 0
    all_gathers: int = 0
    reductions: int = 0
    reduce_scatters: int = 0
    all_reduces: int = 0
    watch: Any = None

    COUNTS = ("calls", "bytes_copied", "all_gathers", "reductions",
              "reduce_scatters", "all_reduces")


GATHER = GatherStats()


def shifted(placements: tuple, by: int) -> tuple:
    """``placements`` of a stacked leaf as those of its slice along its
    ``by`` leading (layer) axes, which no mesh dim may shard."""
    from torch.distributed.tensor import Shard

    out = []
    for p in placements:
        if isinstance(p, Shard):
            if p.dim < by:
                raise ValueError(f"{placements}: a layer axis is sharded")
            p = Shard(p.dim - by)
        out.append(p)
    return tuple(out)


def _all_gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``t`` of ``group`` joined along ``dim``, in rank
    order."""
    import torch.distributed as dist

    part = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * part.shape[0],) + part.shape[1:],
                      dtype=part.dtype, device=part.device)
    dist.all_gather_into_tensor(out, part, group=group)
    GATHER.add("all_gathers")
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(t: torch.Tensor, dim: int, group,
                    n: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``group``'s ``t``."""
    import torch.distributed as dist

    whole = t.movedim(dim, 0).contiguous()
    out = torch.empty((whole.shape[0] // n,) + whole.shape[1:],
                      dtype=whole.dtype, device=whole.device)
    dist.reduce_scatter_tensor(out, whole, group=group)
    GATHER.add("reduce_scatters")
    return out.movedim(0, dim).contiguous()


def _gathers(placements: tuple, mesh) -> list:
    """``(mesh dim, tensor dim)`` of every mesh dim of more than one rank
    that shards a leaf laid out by ``placements``."""
    from torch.distributed.tensor import Shard

    return [(k, p.dim) for k, p in enumerate(placements)
            if isinstance(p, Shard) and mesh.size(k) > 1]


def gather_leaf(part: torch.Tensor, placements: tuple, mesh) -> torch.Tensor:
    """The whole of the leaf whose local shard is ``part``: all-gathered
    over each mesh dim that shards it, the minor dim first (``local_chunk``
    splits the major first); ``part`` itself where none does."""
    for k, d in reversed(_gathers(placements, mesh)):
        part = _all_gather(part, d, mesh.get_group(k), mesh.size(k))
    return part


def reduce_leaf(grad: torch.Tensor, placements: tuple, mesh,
                sum_dims: tuple) -> torch.Tensor:
    """A whole leaf's gradient as this rank's shard of the gradient of the
    step, mesh dim by mesh dim (major first, as ``local_chunk`` splits): a
    dim whose ranks hold parts of the gradient (``sum_dims``: those that
    split the batch, and "model" for a leaf that the model ranks use in
    part) sums, by reduce-scatter where it shards the leaf and all-reduce
    where not; another (its ranks computed the same gradient) takes this
    rank's chunk."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    for k, p in enumerate(placements):
        n = mesh.size(k)
        if n == 1:
            continue
        if isinstance(p, Shard):
            if k in sum_dims:
                grad = _reduce_scatter(grad, p.dim, mesh.get_group(k), n)
            else:
                size = grad.shape[p.dim] // n
                grad = grad.narrow(p.dim, coord[k] * size, size)
        elif k in sum_dims:
            grad = grad.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(grad, group=mesh.get_group(k))
            GATHER.add("all_reduces")
    return grad


def keep_chunk(placements: tuple, dim: int) -> tuple:
    """``placements`` with mesh dim ``dim`` read as Replicate: the layout a
    leaf is gathered by when it keeps this rank's chunk along ``dim``."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if k == dim else p
                 for k, p in enumerate(placements))


class _Gather(torch.autograd.Function):
    """A unit's leaves whole from its shards; the backward reduces each
    whole gradient into its shard (``reduce_leaf``)."""

    @staticmethod
    def forward(ctx, unit: "LayerShards", batch_dims: tuple, *parts):
        ctx.unit, ctx.batch_dims = unit, batch_dims
        return tuple(gather_leaf(s, pl, unit.mesh)
                     for s, pl in zip(parts, unit.placements))

    @staticmethod
    def backward(ctx, *grads):
        unit = ctx.unit
        GATHER.add("reductions")
        return (None, None) + tuple(
            reduce_leaf(g, pl, unit.mesh, ctx.batch_dims + extra)
            for g, pl, extra in zip(grads, unit.placements, unit.sums))


# a leaf's role in the model-parallel region (``LayerShards``' ``roles``)
KEEP, PARTIAL = "keep", "partial"


class LayerShards:
    """One unit of a mesh step's layer loops (a layer, or a list of layers
    gathered together, as a hybrid group), or a model's leaves outside
    them: ``tree`` holds this rank's shard of each leaf, ``placements``
    each leaf's layout on ``mesh`` (in ``_tree.leaves`` order). With
    ``grads`` (a tree of ``tree``'s structure, shapes and dtypes), each
    shard is a leaf tensor whose ``.grad`` is its part of ``grads``: a
    backward accumulates the shard's gradient there, in its dtype.

    ``roles`` (one a leaf, None for all None) says how the leaf meets the
    model-parallel region: ``KEEP``, the block computes with this rank's
    chunk along "model", so the leaf is gathered only over the other mesh
    dims, and its gradient, already this rank's, takes no sum over
    "model"; ``PARTIAL``, the block uses the whole leaf but each model
    rank only in part (its heads' columns, a lookup its heads read), so
    the whole gradient is summed over "model" into the shard; None, the
    leaf is gathered whole and every model rank's gradient of it is the
    same, so each takes its chunk.

    ``gather()`` returns the leaves (whole, or this rank's chunk where
    kept), in ``tree``'s structure. Where no leaf needs a collective
    (every mesh dim that shards it, splits the batch or sums its partial
    gradient has one rank, as on a 1x1 mesh) that is ``tree`` itself, the
    state's own storage, no copy; otherwise ``_Gather``'s outputs, which
    the block that calls it holds only while it runs."""

    def __init__(self, tree: Any, placements: list, mesh,
                 grads: Any = None, roles: Optional[list] = None):
        # each shard a leaf tensor of its own over the same storage
        self.parts = [s.detach() for s in leaves(tree)]
        if grads is not None:
            for s, g in zip(self.parts, leaves(grads)):
                s.requires_grad_(True)
                s.grad = g
        self.tree = unflatten_like(tree, self.parts)
        self.mesh = mesh
        if len(self.parts) != len(placements):
            raise ValueError(f"{len(self.parts)} leaves, "
                             f"{len(placements)} placements")
        roles = [None] * len(placements) if roles is None else list(roles)
        if len(roles) != len(placements):
            raise ValueError(f"{len(placements)} leaves, {len(roles)} roles")
        dim = model_dim_of(mesh)
        if dim is None or mesh.size(dim) == 1:
            roles = [None] * len(roles)
        self.roles = roles
        # the layouts each leaf is gathered by, and the mesh dims over
        # which its gradient sums beside the batch's
        self.placements = [keep_chunk(pl, dim) if r == KEEP else tuple(pl)
                           for pl, r in zip(placements, roles)]
        self.sums = [(dim,) if r == PARTIAL else () for r in roles]
        self.sharded = any(_gathers(pl, mesh) for pl in self.placements)

    def gather(self) -> Any:
        GATHER.add("calls")
        dims = _CTX.batch_dims
        grad = torch.is_grad_enabled() and self.parts[0].requires_grad
        if not self.sharded and not (grad and (dims or any(self.sums))):
            return self.tree
        whole = _Gather.apply(self, tuple(dims), *self.parts)
        GATHER.add("bytes_copied", sum(
            w.nbytes for w, s in zip(whole, self.parts)
            if memory_key(w) != memory_key(s)))
        if GATHER.watch is not None:
            for w in whole:
                GATHER.watch(w)
        return unflatten_like(self.tree, whole)
