"""Multi-pod dry run: every (architecture × shape) cell on the production
meshes (16×16 = 256 ranks, 2×16×16 = 512) without their ranks; one JSON
record per cell.

    python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape prefill_32k --mesh single

Counterpart of the JAX package's ``launch/dryrun.py``, redesigned: the port
has no compiler, so nothing is lowered or compiled. A cell's step
(``launch/steps.py`` ``build_cell_program``, the step the trainer and the
server run) runs once, eagerly, on fake tensors (``FakeTensor``: shapes,
dtypes and no storage) in a fake world (``fake_world``: a "fake" default
process group of 256 or 512 ranks in this process, whose collectives issue
nothing), as one rank of it. ``CellProgram.lower()`` (``lower_program``)
reads the run the way the reference reads its compiled program:

- ``cost_analysis()``: ``flops``, the aten ops' (``FlopCounterMode``) and
  the kernels' own (each kernel module's ``cost``: B3 over the pairs its
  mask lets through, B4 and B2 by their own counts; the wrappers count them
  on fake tensors and run neither a kernel nor its plain version,
  ``kernels/_build.py``); ``bytes accessed``, the operand and result bytes
  of every op dispatched (views and empty allocations apart) and the
  kernels' own;
- ``memory_analysis()``: the arguments' local shard bytes by their layouts,
  the outputs' local bytes, the aliases (donated arguments whose storage
  the outputs reuse) and the temporaries (the most bytes of storages made
  by the run alive at once, less the outputs in new storage), so that
  arguments + temporaries + outputs − aliases is the rank's peak (beyond
  one rank a floor: a communicator may hold tensors the program has let
  go);
- ``collective_stats()``, in place of ``as_text()``: every c10d collective
  the run issues, its kind, result bytes and group size
  (``issued_collective``; ``IssuedCollectives`` records the same on a
  world of cards), billed by ``core/hlo_analysis.py``'s ring conventions
  (``issued_collective_stats``).

Named divergences from the reference (ROADMAP.md, Queue 3):

- bytes are unfused: every op's operands and results, where XLA's figure
  is after fusion;
- memory is tracked from the storages the run makes, with no allocator:
  no alignment, fragmentation, or workspace a kernel allocates itself;
- the compute probes run at the real layout: the reference drops ``seq``
  for them because an XLA copy artifact corrupts its byte counts; an eager
  run has no such artifact;
- the accumulation split (``probe_costs``): the port runs each
  microbatch, so a cost at accum a >= 2 is a·W + C, split from probes at
  accum 2 and 4 (the reference's HLO counts a scanned microbatch once, and
  it probes accum 1 and 2); a hybrid's tail layers are probed
  (``_delta_total``), where the reference bills them as a fraction of a
  group; enc-dec's deltas run from one encoder and one decoder layer,
  where the reference's run from none.

Each ``run_cell`` starts a fake world of its own and ends it, and refuses
to start where a default process group already exists (one a process):
no cell replaces a group. The records go to ``results/dryrun_torch`` by
default, beside (never over) the reference's ``results/dryrun``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch._tree import leaves, tree_map
from repro_torch.configs import SHAPES, cell_supported, get_config, \
    list_configs
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.hlo_analysis import CollectiveStats, \
    issued_collective_stats
from repro_torch.core.lm_cost_model import Decisions
from repro_torch.launch.mesh import chips, make_production_mesh, \
    mesh_shape_dict

# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A "fake" default process group of ``world`` ranks in this process,
    this process rank ``rank`` of it: its collectives issue nothing and
    return at once, leaving their outputs as they were. Ended on exit.
    Refuses to start where a default group exists: a process has one, and
    a dry run never replaces it (nor meets it)."""
    if dist.is_initialized():
        raise RuntimeError(
            f"a fake world needs a process of its own: this one already has "
            f"a default process group ({dist.get_backend()}, "
            f"{dist.get_world_size()} ranks)")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def in_fake_world() -> bool:
    return dist.is_initialized() and dist.get_backend() == "fake"


# ---------------------------------------------------------------------------
# What a step's run issues: op bytes, storages alive, collectives
# ---------------------------------------------------------------------------

def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_of_name(name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name)


def _sum_bytes(ts) -> int:
    return sum(_nbytes(t) for t in ts)


# the collectives the port issues: (kind, (result bytes, group) from the
# op's arguments); another raises in the dry run
_COLLECTIVE_OPS = {
    # c10d's (torch.distributed's calls: the layer gather, the sequence
    # split, the model region, the batch and optimizer sums)
    "c10d.allreduce_": ("all-reduce", lambda a: (_sum_bytes(a[0]), a[1])),
    "c10d._allgather_base_": ("all-gather", lambda a: (_nbytes(a[0]), a[2])),
    "c10d._reduce_scatter_base_": ("reduce-scatter",
                                   lambda a: (_nbytes(a[0]), a[2])),
    # the functional collectives (DTensor's redistributions)
    "_c10d_functional.all_reduce": ("all-reduce", lambda a: (
        _nbytes(a[0]), _group_of_name(a[2]))),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", lambda a: (
        _nbytes(a[0]) * a[1], _group_of_name(a[2]))),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", lambda a: (
        _nbytes(a[0]) // a[2], _group_of_name(a[3]))),
    "_c10d_functional.all_to_all_single": ("all-to-all", lambda a: (
        _nbytes(a[0]), _group_of_name(a[3]))),
}
# ops of those namespaces that move nothing
_QUIET = {"_c10d_functional.wait_tensor",
          "_c10d_functional._wrap_tensor_autograd", "c10d.barrier",
          "c10d.monitored_barrier_"}
# ops that allocate or alias and move no bytes
_NO_BYTES = {"aten.empty", "aten.empty_like", "aten.empty_strided",
             "aten.new_empty", "aten.new_empty_strided", "aten.detach",
             "aten.alias", "aten.lift_fresh", "aten._local_scalar_dense",
             "aten._unsafe_view"}


def issued_collective(func, args) -> Optional[tuple[str, int, int]]:
    """``(kind, result bytes, group size)`` of the collective ``func``
    called on ``args``; None for every other op, and for the ops of those
    namespaces that move nothing (``_QUIET``). A collective the dry run
    has no billing for raises."""
    if func.namespace not in ("c10d", "_c10d_functional"):
        return None
    name = f"{func.namespace}.{func._opname}"
    if name in _QUIET:
        return None
    if name not in _COLLECTIVE_OPS:
        raise NotImplementedError(
            f"the dry run has no billing for collective {func}")
    kind, read = _COLLECTIVE_OPS[name]
    size, group = read(args)
    if not isinstance(group, dist.ProcessGroup):  # c10d's boxed
        group = dist.ProcessGroup.unbox(group)
    return kind, int(size), int(group.size())


class IssuedCollectives:
    """A dispatch mode that records every collective a run issues on any
    tensors (a world of cards, to hold against the dry run), as
    ``issued_collective`` bills it, and how many (``report``). With ``on``
    false it records nothing."""

    def __init__(self, on: bool = True):
        from torch.utils._python_dispatch import TorchDispatchMode

        seen = self.seen = collections.Counter()
        self.on = on

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                issued = issued_collective(func, args)
                if issued is not None:
                    seen[issued] += 1
                return out

        self.mode = Mode()

    def __enter__(self):
        if self.on:
            self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        if self.on:
            return self.mode.__exit__(*exc)

    def report(self) -> list:
        """``[kind, result bytes, group size, how many]``, sorted."""
        return sorted([*k, n] for k, n in self.seen.items())


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Recorder:
    """A dispatch mode over a step's run on fake tensors: each op's operand
    and result bytes (``bytes``), the storages the run makes and the most
    bytes of them alive at once (``peak``; a storage lives while any tensor
    on it does, by weak references), and each collective as ``(kind,
    result bytes, group size)`` (``collectives``). ``before``: the keys of
    storages alive before the run (the arguments'), which it never
    counts."""

    def __init__(self, before: set):
        from torch.utils._python_dispatch import TorchDispatchMode

        rec = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                rec.saw(func, args, kwargs or {}, out)
                return out

        self.mode = Mode()
        self.before = before
        self.bytes = 0
        self.collectives: list[tuple[str, int, int]] = []
        self.refs: collections.Counter = collections.Counter()
        self.sizes: dict[int, int] = {}
        self.live = self.peak = 0

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    def saw(self, func, args, kwargs, out) -> None:
        from torch.utils._pytree import tree_leaves

        name = f"{func.namespace}.{func._opname}"
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self.track(t)
        if func.namespace in ("c10d", "_c10d_functional"):
            issued = issued_collective(func, args)
            if issued is not None:
                self.collectives.append(issued)
            return
        # bytes move in aten's ops that make a tensor, not in its views and
        # allocations, nor in the queries of a tensor's metadata
        if func.namespace != "aten" or func.is_view or name in _NO_BYTES \
                or not outs:
            return
        self.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs))
                          if isinstance(t, torch.Tensor)) + _sum_bytes(outs)

    def track(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":  # shapes alone, on the card too
            return
        key = _storage_key(t)
        if key in self.before:
            return
        if not self.refs[key]:
            self.sizes[key] = t.untyped_storage().nbytes()
            self.live += self.sizes[key]
            self.peak = max(self.peak, self.live)
        self.refs[key] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.live -= self.sizes.pop(key)


@dataclass(frozen=True)
class MemoryAnalysis:
    """A rank's memory in the reference's names (XLA's
    ``memory_analysis()``), in bytes."""
    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    alias_size_in_bytes: int

    @property
    def peak(self) -> int:
        return (self.argument_size_in_bytes + self.temp_size_in_bytes
                + self.output_size_in_bytes - self.alias_size_in_bytes)


@dataclass
class Lowered:
    """One rank's reading of a step's run on fake tensors
    (``lower_program``). ``compile()`` returns it as it is: the reference's
    ``lower().compile()`` reads the same three things."""
    description: str
    aten_flops: int
    op_bytes: int
    kernels: dict
    collectives: list
    memory: MemoryAnalysis
    trace_s: float
    rank: int = 0

    def compile(self) -> "Lowered":
        return self

    def cost_analysis(self) -> dict:
        return {"flops": float(self.aten_flops + sum(
                    k["flops"] for k in self.kernels.values())),
                "bytes accessed": float(self.op_bytes + sum(
                    k["bytes"] for k in self.kernels.values()))}

    def memory_analysis(self) -> MemoryAnalysis:
        return self.memory

    def collective_stats(self) -> CollectiveStats:
        return issued_collective_stats(self.collectives)


def _local(t):
    from repro_torch.parallel.sharding import local

    return local(t)


def lower_program(prog) -> Lowered:
    """Run ``prog.fn`` (a ``CellProgram``) once on fake tensors shaped by
    ``prog.args`` and laid out by ``prog.in_shardings``, as this rank of
    the fake world that must be running (``fake_world``), and read it
    (``Lowered``). The caller activates the mesh and rules as for the real
    step (``sharding.use_mesh``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels._build import counting_kernels
    from repro_torch.launch.steps import place

    if not in_fake_world():
        raise RuntimeError(
            f"lower() runs {prog.description!r} on fake tensors as one rank "
            f"of a fake world; start one first (launch/dryrun.py "
            f"fake_world), never a real group")
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype),
                        prog.args)
        placed = tuple(place(a, s) for a, s in zip(args, prog.in_shardings))
        del args
        arg_locals = [_local(t) for t in leaves(placed)]
        before = {_storage_key(t) for t in arg_locals}
        donated = {_storage_key(_local(t)) for k in prog.donate_argnums
                   for t in leaves(placed[k])}
        with counting_kernels() as kernels, \
                FlopCounterMode(display=False) as fc, \
                _Recorder(before) as rec:
            out = prog.jitted()(*placed)
        outs = [_local(t) for t in leaves(out)
                if isinstance(t, torch.Tensor)]
        seen: set = set()
        out_bytes = alias = new = 0
        for t in outs:
            out_bytes += _nbytes(t)
            key = _storage_key(t)
            if key in seen:
                continue
            seen.add(key)
            if key in donated:
                alias += _nbytes(t)
            elif key not in before:
                new += _nbytes(t)
        memory = MemoryAnalysis(
            argument_size_in_bytes=sum(_nbytes(t) for t in arg_locals),
            output_size_in_bytes=out_bytes,
            temp_size_in_bytes=max(rec.peak - new, 0),
            alias_size_in_bytes=alias)
        del out, outs, placed, arg_locals
    return Lowered(description=prog.description,
                   aten_flops=int(fc.get_total_flops()),
                   op_bytes=int(rec.bytes), kernels=dict(kernels),
                   collectives=list(rec.collectives), memory=memory,
                   trace_s=time.perf_counter() - t0, rank=dist.get_rank())


def summary(low: Lowered) -> dict:
    """A reading as plain JSON: flops and bytes (``cost_analysis``), the
    kernels' own counts, the collectives (wire bytes by the ring
    conventions, and the issued ones as ``[kind, result bytes, group size,
    how many]``) and the memory, with the peak."""
    ca = low.cost_analysis()
    coll = low.collective_stats()
    ma = low.memory_analysis()
    issued = collections.Counter(low.collectives)
    return {"rank": low.rank, "flops": ca["flops"],
            "bytes": ca["bytes accessed"], "aten_flops": low.aten_flops,
            "kernels": low.kernels,
            "collectives": {"count": coll.count,
                            "wire_bytes": coll.wire_bytes,
                            "by_kind": coll.by_kind,
                            "issued": sorted([*k, n]
                                             for k, n in issued.items())},
            "memory": {**dataclasses.asdict(ma), "peak": ma.peak},
            "trace_s": low.trace_s}


def dry_run(cfg: ArchConfig, shape: ShapeSpec, mesh_shape: tuple,
            axes: tuple = ("data", "model"), *, rank: int = 0,
            overrides: Optional[dict] = None, dec=None) -> dict:
    """``summary`` of ``cfg``'s step for ``shape`` (``build_cell_program``)
    as rank ``rank`` of a fake world of a ``mesh_shape`` mesh named
    ``axes``, under ``rules_for``'s layout with ``overrides``; the world is
    started here and ended on return, and the process must have no
    other."""
    from repro_torch.launch.mesh import make_mesh_compat

    with fake_world(math.prod(mesh_shape), rank):
        mesh = make_mesh_compat(mesh_shape, axes, device="cpu")
        low, prog = _lower(cfg, shape, mesh, dec, overrides)
    out = summary(low)
    out["mesh"] = dict(zip(axes, mesh_shape))
    out["description"] = prog.description
    return out


# ---------------------------------------------------------------------------
# The cells and the delta method
# ---------------------------------------------------------------------------


def _with_depth(cfg: ArchConfig, n: int, keep_accum: bool = False,
                tail: int = 0) -> ArchConfig:
    """``cfg`` at ``n`` layers (a hybrid: ``n`` groups and ``tail`` Mamba
    layers after them), at accum 1 unless ``keep_accum``."""
    ch: dict = {} if keep_accum else {"accum": 1}
    if cfg.family == "hybrid":
        ch["num_layers"] = n * (cfg.attn_every or 1) + tail
        ch["attn_every"] = cfg.attn_every
    else:
        ch["num_layers"] = n
    return dataclasses.replace(cfg, **ch)


def _with_enc_depth(cfg: ArchConfig, e: int, l: int,
                    keep_accum: bool = False) -> ArchConfig:
    ch = {"encoder_layers": e, "num_layers": l}
    if not keep_accum:
        ch["accum"] = 1
    return dataclasses.replace(cfg, **ch)


def _rules(cfg, shape, mesh, overrides):
    from repro_torch.parallel.layouts import rules_for

    return rules_for(cfg, shape, mesh, overrides=overrides)


def _lower(cfg, shape, mesh, dec, overrides=None) -> tuple[Lowered, Any]:
    from repro_torch.launch.steps import build_cell_program
    from repro_torch.parallel.sharding import use_mesh

    rules = _rules(cfg, shape, mesh, overrides)
    prog = build_cell_program(cfg, shape, mesh, rules, dec)
    with use_mesh(mesh, rules):
        return prog.lower().compile(), prog


def _cost(cfg, shape, mesh, dec, *, overrides=None) -> dict:
    low, _ = _lower(cfg, shape, mesh, dec, overrides)
    ca = low.cost_analysis()
    coll = low.collective_stats()
    out = {"flops": ca["flops"], "bytes": ca["bytes accessed"],
           "collective_bytes": coll.wire_bytes,
           "collective_by_kind": coll.by_kind,
           "collective_count": coll.count}
    return out


def _keys(r: dict) -> dict:
    """A probe's costs as one flat dict of floats: flops, bytes, wire
    bytes, and wire bytes and count by kind."""
    out = {k: float(r[k]) for k in ("flops", "bytes", "collective_bytes",
                                    "collective_count")}
    for kind, v in r["collective_by_kind"].items():
        out[f"collective/{kind}"] = float(v)
    return out


def _combine(terms: list[tuple[float, dict]]) -> dict:
    """Σ weight · probe over every key any probe has."""
    keys = sorted({k for _, r in terms for k in _keys(r)})
    return {k: sum(w * _keys(r).get(k, 0.0) for w, r in terms)
            for k in keys}


def _delta_total(cfg: ArchConfig, shape: ShapeSpec, mesh, dec, *,
                 overrides=None,
                 keep_accum: bool = False) -> tuple[dict, dict]:
    """raw(0) + depth·(raw(1) − raw(0)) per family structure; a hybrid's
    tail layers by a probe of their own: + tail·(raw(1 group, 1 tail) −
    raw(1 group)); enc-dec's two deltas from (1, 1) encoder and decoder
    layers, since a config of no encoder layer is not an enc-dec one."""
    kw = dict(overrides=overrides)
    if cfg.is_encdec:  # from (1, 1): no encoder layer is no enc-dec config
        r11 = _cost(_with_enc_depth(cfg, 1, 1, keep_accum), shape, mesh,
                    dec, **kw)
        r21 = _cost(_with_enc_depth(cfg, 2, 1, keep_accum), shape, mesh,
                    dec, **kw)
        r12 = _cost(_with_enc_depth(cfg, 1, 2, keep_accum), shape, mesh,
                    dec, **kw)
        e, n = cfg.encoder_layers, cfg.num_layers
        total = _combine([(3 - e - n, r11), (e - 1, r21), (n - 1, r12)])
        return total, {"e1l1": r11, "e2l1": r21, "e1l2": r12}
    r0 = _cost(_with_depth(cfg, 0, keep_accum), shape, mesh, dec, **kw)
    r1 = _cost(_with_depth(cfg, 1, keep_accum), shape, mesh, dec, **kw)
    probes = {"l0": r0, "l1": r1}
    if cfg.family == "hybrid":
        every = cfg.attn_every or cfg.num_layers
        depth, tail = divmod(cfg.num_layers, every)
        terms = [(1 - depth, r0), (depth, r1)]
        if tail:
            rt = _cost(_with_depth(cfg, 1, keep_accum, tail=1), shape, mesh,
                       dec, **kw)
            probes["l1t1"] = rt
            terms += [(tail, rt), (-tail, r1)]
        return _combine(terms), probes
    depth = cfg.num_layers
    return _combine([(1 - depth, r0), (depth, r1)]), probes


def _probe_accums(cfg: ArchConfig, shape: ShapeSpec) -> tuple[int, ...]:
    """The accumulations the probes run at: the step's own at 1 or 2;
    beyond, 2 and 4 (where the batch takes 4 microbatches, else the
    step's own), from which ``probe_costs`` extrapolates."""
    accum = cfg.accum if shape.kind == "train" else 1
    if accum <= 2:
        return (accum,)
    return (2, 4 if shape.global_batch % 4 == 0 else accum)


def probe_costs(cfg: ArchConfig, shape: ShapeSpec, mesh, dec,
                overrides: Optional[dict] = None) -> dict:
    """Delta-method per-rank totals (flops, bytes, collective wire bytes,
    and wire bytes by kind) of a full-depth, full-accumulation step.

    Every probe runs at the real layout (the reference drops ``seq`` for
    its compute probes, for an XLA copy artifact an eager run has not).
    Accumulation: the port runs each microbatch, so a cost at accum a >= 2
    is a·W + C (W: a microbatch's weight-proportional part, the layer
    gathers and their gradients' reductions; C: the rest, the activations'
    share, batch-linear, and the optimizer's); accum 1 reduces its metrics
    by another path, so the probes run at a1 = 2 and a2 = 4:
        W = (cost(a2) − cost(a1)) / (a2 − a1),  C = cost(a1) − a1·W
        step total = accum·W + C,
    where the reference probes accum 1 and 2 and its HLO counts a scanned
    microbatch once (coll(2) = W + Act/2). Exact wherever the costs are
    affine in accum and each microbatch splits over the batch's mesh dims
    alike at every accum."""
    accum = cfg.accum if shape.kind == "train" else 1
    accums = _probe_accums(cfg, shape)
    totals, out_probes = [], {}
    for a in accums:
        keep = a != 1
        total, probes = _delta_total(dataclasses.replace(cfg, accum=a),
                                     shape, mesh, dec, overrides=overrides,
                                     keep_accum=keep)
        totals.append(total)
        out_probes[f"accum{a}"] = probes
    total = totals[0]
    if len(accums) == 2 and accums[1] != accums[0]:
        a1, a2 = accums
        t1, t2 = totals
        total = {}
        for k in sorted(set(t1) | set(t2)):
            w = (t2.get(k, 0.0) - t1.get(k, 0.0)) / (a2 - a1)
            total[k] = accum * w + t1.get(k, 0.0) - a1 * w
    elif accums[-1] != accum:
        raise ValueError(f"probes at accum {accums} for a step of {accum}")
    return {"total_per_device": {
                "flops": total["flops"], "bytes": total["bytes"],
                "collective_bytes": total["collective_bytes"],
                "collective_count": total["collective_count"],
                "collective_by_kind": {
                    k.split("/", 1)[1]: v for k, v in total.items()
                    if k.startswith("collective/")}},
            "probes": out_probes, "accum": accum, "probe_accums": accums}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             dec: Optional[Decisions] = None, skip_probes: bool = False,
             overrides: Optional[dict] = None, rank: int = 0) -> dict:
    """One cell's record, as rank ``rank`` of a fake world of the
    production mesh's size, started here and ended on return."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    world = 512 if multi_pod else 256
    record: dict = {
        "arch": arch, "shape": shape_name, "rank": rank,
        "decisions": dataclasses.asdict(dec) if dec else None,
        "overrides": overrides,
    }
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        record["status"] = "skipped"
        record["reason"] = reason
        return record
    with fake_world(world, rank):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        record["mesh"] = mesh_shape_dict(mesh)
        record["chips"] = chips(mesh)
        low, prog = _lower(cfg, shape, mesh, dec, overrides)
        record["trace_s"] = round(low.trace_s, 2)
        ma = low.memory_analysis()
        ca = low.cost_analysis()
        record["memory"] = {
            "argument_bytes": int(ma.argument_size_in_bytes),
            "output_bytes": int(ma.output_size_in_bytes),
            "temp_bytes": int(ma.temp_size_in_bytes),
            "alias_bytes": int(ma.alias_size_in_bytes),
            "peak_per_device": int(ma.peak),
        }
        record["artifact_cost_analysis"] = {
            "flops": ca["flops"], "bytes": ca["bytes accessed"],
            "aten_flops": float(low.aten_flops),
        }
        record["kernels"] = low.kernels
        coll = low.collective_stats()
        record["artifact_collectives"] = {
            "wire_bytes_per_device": coll.wire_bytes,
            "by_kind": coll.by_kind, "count": coll.count,
        }
        if not skip_probes:
            t2 = time.perf_counter()
            record["probe"] = probe_costs(cfg, shape, mesh, dec,
                                          overrides=overrides)
            record["probe_s"] = round(time.perf_counter() - t2, 2)
    record["status"] = "ok"
    record["description"] = prog.description
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="multi-pod dry run on a fake world (no ranks, no card)")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-probes", action="store_true")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the fake world to read (default 0)")
    ap.add_argument("--overrides", default=None,
                    help="JSON of the rules' overrides, e.g. "
                         "'{\"seq_inner\": null}'")
    args = ap.parse_args(argv)

    archs = list_configs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    overrides = json.loads(args.overrides) if args.overrides else None
    os.makedirs(args.out, exist_ok=True)

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
                if args.rank:
                    tag += f"__rank{args.rank}"
                if overrides:
                    tag += "__" + "_".join(
                        f"{k}-{v}" for k, v in sorted(overrides.items()))
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[skip existing] {tag}")
                    continue
                print(f"=== {tag} ===", flush=True)
                try:
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   skip_probes=args.skip_probes,
                                   overrides=overrides, rank=args.rank)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()}
                    failures += 1
                    print(rec["error"], flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"[{rec['status']}] {tag}", flush=True)
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
