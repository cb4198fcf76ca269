"""Traverse traced FX graphs and derive per-region static cost estimates.

Counterpart of the JAX package's ``analysis/jaxpr_walk.py``. The paper
parses C ``for`` statements for offloadable regions; the JAX package walks
the ``ClosedJaxpr`` of a traced program; the port traces the same function
with ``make_fx`` on fake tensors (shapes, dtypes, no storage; nothing runs
on a device) and walks the FX graph, recursing into the subgraphs of the
higher-order ops (``scan``, ``while_loop``, ``cond`` and any other that
holds one). It classifies every node (matmul / elementwise / scatter /
collective / callback / kernel / control) and accumulates FLOPs, an HBM-byte
proxy and trip counts per region. The result cross-checks
``core/arithmetic_intensity.py``'s config-derived estimates against what
the traced program contains, and feeds the rules of
:mod:`repro_torch.analysis.offload_lint`.

Conventions (the reference's, so the consistency test states the same
tolerances):

* FLOPs: ``mm``/``bmm``/``addmm``/``baddbmm`` count ``2 * batch * M * N *
  K``; a convolution ``2 * out elements * kernel elements an output
  channel``; float elementwise ops count one FLOP per output element;
  reductions one per input element; integer/bool ops, layout ops,
  gathers and scatters (data movement: an in-place ``index_put_`` into a
  KV cache returns the whole cache, of which it writes a row) and
  allocations (``empty*``, which write nothing) zero.
* Bytes: each node charges ``sum(input bytes) + sum(output bytes)``, an
  unfused upper bound; allocations charge nothing.
* Trip counts: ``scan`` multiplies its body by its length (the leading
  axis of its ``xs``), the region tagged ``scan[xN]``; ``while_loop``
  bodies count once and are recorded in ``RegionReport.dynamic_loops``;
  ``cond`` charges its most expensive branch.
* Kernels: a kernel wrapper given fake tensors adds one
  ``repro_torch::launch`` node (``kernels/_build.py``), charged its kernel
  module's ``cost``, the numbers the dry run counts; its primitive is the
  wrapper's name (``rms_norm``, ``wkv``, ...).
* Host syncs (callbacks): ``_local_scalar_dense`` (``.item()``),
  ``nonzero`` and the like, and a copy to the CPU of a tensor on the card
  (``.cpu()``, ``.to("cpu")``), each only where an operand lies on the
  card.

The port's layer loops are Python loops, so a traced graph unrolls them:
where the reference's jaxpr holds one ``scan[xL]`` region over the layers,
the port's graph holds L copies of the layer's nodes, whose totals are the
same.

On a build of PyTorch without CUDA, a fake tensor on the card cannot be
indexed with ``[]``, nor take ``copy_`` or ``contiguous`` (their bindings
guard its device); ``trace`` then applies them as the ops PyTorch
dispatches: ``select``, ``slice``, ``unsqueeze``, ``index``,
``index_put_``, ``copy_`` and ``clone``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import operator
import warnings
from collections import Counter
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.overrides import TorchFunctionMode

# ---------------------------------------------------------------------------
# Node classification
# ---------------------------------------------------------------------------

MATMUL = "matmul"
ELEMENTWISE = "elementwise"
SCATTER = "scatter"
COLLECTIVE = "collective"
CALLBACK = "callback"
CONTROL = "control"
KERNEL = "kernel"
OTHER = "other"

KINDS = (MATMUL, ELEMENTWISE, SCATTER, COLLECTIVE, CALLBACK, CONTROL, KERNEL,
         OTHER)

_MATMUL_PRIMS = {"mm", "bmm", "addmm", "baddbmm", "convolution"}
_COLLECTIVE_PREFIXES = ("c10d_functional.", "_c10d_functional.")
# host syncs by name; a copy to the CPU is one by its operands
_CALLBACK_PRIMS = {"_local_scalar_dense", "nonzero", "masked_select",
                   "_unique2", "unique_dim", "unique_consecutive"}
_HOST_COPY_PRIMS = {"_to_copy", "copy_", "copy", "_copy_from"}
_CONTROL_PRIMS = {"cond", "while_loop", "scan", "map_impl", "wrap",
                  "wrap_with_set_grad_enabled", "wrap_with_autocast",
                  "tag_activation_checkpoint", "invoke_subgraph",
                  "auto_functionalized", "with_effects"}
# one launch of each of the port's kernel wrappers (kernels/_build.py
# record_fake's names)
KERNEL_PRIMS = {"rms_norm", "rms_norm_backward", "flash_attention",
                "flash_attention_backward", "wkv", "wkv_backward",
                "himeno_sweep", "himeno_stencil"}
# gather/scatter-family data movement (the decode KV write path lives here)
_SCATTER_PRIMS = {"index_put", "index_put_", "index_copy", "index_copy_",
                  "gather", "index_select", "index", "sort", "argsort",
                  "embedding", "index_add", "index_add_"}
# layout/metadata ops: no FLOPs, and usually folded into their consumers,
# but bytes are still charged (a conservative upper bound)
_LAYOUT_PRIMS = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "squeeze", "unsqueeze", "select", "slice", "narrow", "cat",
    "stack", "split", "split_with_sizes", "unbind", "clone", "alias",
    "as_strided", "flip", "roll", "constant_pad_nd", "arange", "detach",
    "where", "_to_copy", "copy_", "copy", "lift_fresh_copy", "repeat",
    "full", "full_like", "zeros", "zeros_like", "ones", "ones_like",
    "fill", "fill_", "scalar_tensor", "view_as_real", "view_as_complex",
    "convert_element_type", "_copy_from",
}
# allocations: nothing written, nothing charged
_ALLOC_PRIMS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided", "empty_permuted"}
# reductions: one FLOP per input element
_REDUCE_PRIMS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "cumsum", "cumprod", "logcumsumexp", "cummax", "cummin", "logsumexp",
    "var", "var_mean", "std", "norm", "linalg_vector_norm", "any", "all",
}


def classify_primitive(name: str) -> str:
    """Map a primitive name (an aten op's name, ``ns.name`` for another
    namespace, a higher-order op's name, a kernel wrapper's name) to one of
    the coarse KINDS buckets."""
    if name in _MATMUL_PRIMS:
        return MATMUL
    if name in KERNEL_PRIMS:
        return KERNEL
    if name in _CALLBACK_PRIMS:
        return CALLBACK
    if name.startswith(_COLLECTIVE_PREFIXES):
        return COLLECTIVE
    if name in _CONTROL_PRIMS:
        return CONTROL
    if name in _SCATTER_PRIMS or "scatter" in name:
        return SCATTER
    # default bucket: layout, reductions and unary/binary math (add, mul,
    # exp, tanh, ...)
    return ELEMENTWISE


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _size(t: torch.Tensor) -> int:
    n = 1
    for d in t.shape:
        n *= int(d)
    return n


def _bytes(t: torch.Tensor) -> int:
    return _size(t) * t.element_size()


def _tensors(obj: Any, gm: Any) -> List[torch.Tensor]:
    """The tensor values of the nodes in ``obj`` (a node, or lists, tuples
    and dicts of them and of constants)."""
    out: List[torch.Tensor] = []

    def visit(o):
        if isinstance(o, torch.fx.Node):
            v = _value(o, gm)
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                out.extend(x for x in v if isinstance(x, torch.Tensor))
        elif isinstance(o, (list, tuple)):
            for x in o:
                visit(x)
        elif isinstance(o, dict):
            for x in o.values():
                visit(x)

    visit(obj)
    return out


def _fetch(gm: Any, target: str) -> Any:
    obj = gm
    for part in target.split("."):
        obj = getattr(obj, part)
    return obj


def _value(node: torch.fx.Node, gm: Any) -> Any:
    """A node's traced value: its ``val`` meta, or the attribute a
    ``get_attr`` node reads."""
    if "val" in node.meta:
        return node.meta["val"]
    if node.op == "get_attr":
        return _fetch(gm, node.target)
    return None


def _op_name(node: torch.fx.Node) -> str:
    """A call node's primitive name: an aten op's name, ``ns.name`` for an
    op of another namespace, a higher-order op's name, and a kernel
    launch's wrapper name."""
    target = node.target
    schema = getattr(target, "_schema", None)
    if schema is not None:
        ns, _, name = schema.name.partition("::")
        if ns == "repro_torch" and name == "launch":
            return str(node.args[0])
        return name if ns == "aten" else "%s.%s" % (ns, name)
    if isinstance(target, torch._ops.HigherOrderOperator):
        return target.name()
    return getattr(target, "__name__", str(target))


def _on_card(tensors: List[torch.Tensor]) -> bool:
    return any(t.device.type != "cpu" for t in tensors)


def _host_copy(name: str, node: torch.fx.Node, gm: Any) -> bool:
    """A copy to the CPU of a tensor on the card: ``_to_copy`` (``.cpu()``,
    ``.to("cpu")``) or ``copy_`` into a CPU tensor."""
    if name not in _HOST_COPY_PRIMS:
        return False
    out = _value(node, gm)
    if name in ("copy_", "copy"):
        dst = _tensors(node.args[:1], gm)
        src = _tensors(node.args[1:2], gm)
        return bool(dst) and dst[0].device.type == "cpu" and _on_card(src)
    return (isinstance(out, torch.Tensor) and out.device.type == "cpu"
            and _on_card(_tensors(node.args, gm)))


def _matmul_flops(name: str, ins: List[torch.Tensor],
                  out: Any) -> float:
    """2 * batch * M * N * K of a product, from its operands."""
    if name == "convolution":
        w = ins[1]
        return 2.0 * _size(out) * _size(w) / max(int(w.shape[0]), 1)
    a, b = (ins[1], ins[2]) if name in ("addmm", "baddbmm") else (ins[0],
                                                                    ins[1])
    k = int(a.shape[-1])
    batch = int(a.shape[0]) if a.dim() == 3 else 1
    return 2.0 * batch * int(a.shape[-2]) * int(b.shape[-1]) * k


def _node_cost(name: str, node: torch.fx.Node, gm: Any,
               ins: List[torch.Tensor], outs: List[torch.Tensor]
               ) -> Tuple[float, float]:
    if name in KERNEL_PRIMS:
        return float(node.args[1]), float(node.args[2])
    if name in _ALLOC_PRIMS:
        return 0.0, 0.0
    nbytes = float(sum(_bytes(t) for t in ins) + sum(_bytes(t) for t in outs))
    if name in _MATMUL_PRIMS:
        return _matmul_flops(name, ins, outs[0] if outs else None), nbytes
    if name in _LAYOUT_PRIMS or classify_primitive(name) == SCATTER:
        return 0.0, nbytes
    if name in _REDUCE_PRIMS:
        return float(sum(_size(t) for t in ins[:1])), nbytes
    return float(sum(_size(t) for t in outs if t.dtype.is_floating_point)), \
        nbytes


# ---------------------------------------------------------------------------
# Region reports
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EqnStats:
    """Accumulated cost for one classification bucket."""

    count: float = 0.0
    flops: float = 0.0
    bytes: float = 0.0

    def add(self, flops: float, nbytes: float, mult: float) -> None:
        self.count += mult
        self.flops += flops * mult
        self.bytes += nbytes * mult


@dataclasses.dataclass
class RegionReport:
    """Static cost summary of one graph region (and its sub-regions).

    ``flops`` / ``hbm_bytes`` are totals with trip counts applied;
    ``regions`` maps sub-region paths (e.g. ``".../scan:3/scan[x5]"``) to
    their own reports so callers can inspect loop bodies; ``callbacks``
    (host syncs) and ``dynamic_loops`` record hazard sites for the lint
    layer; ``conversions`` each dtype change (``_to_copy`` with a dtype)."""

    path: str = ""
    trip_count: float = 1.0
    flops: float = 0.0
    hbm_bytes: float = 0.0
    eqn_count: float = 0.0
    by_kind: Dict[str, EqnStats] = dataclasses.field(
        default_factory=lambda: {k: EqnStats() for k in KINDS})
    primitive_counts: Counter = dataclasses.field(default_factory=Counter)
    callbacks: List[str] = dataclasses.field(default_factory=list)
    dynamic_loops: List[str] = dataclasses.field(default_factory=list)
    conversions: List[Tuple[str, str, str, int]] = dataclasses.field(
        default_factory=list)  # (path, from_dtype, to_dtype, out_bytes)
    regions: Dict[str, "RegionReport"] = dataclasses.field(default_factory=dict)

    @property
    def intensity(self) -> float:
        """FLOPs per HBM byte (lower bound: bytes are an unfused bound)."""
        return self.flops / self.hbm_bytes if self.hbm_bytes else 0.0

    def merge_child(self, child: "RegionReport", mult: float) -> None:
        self.flops += child.flops * mult
        self.hbm_bytes += child.hbm_bytes * mult
        self.eqn_count += child.eqn_count * mult
        for kind, stats in child.by_kind.items():
            mine = self.by_kind[kind]
            mine.count += stats.count * mult
            mine.flops += stats.flops * mult
            mine.bytes += stats.bytes * mult
        for name, n in child.primitive_counts.items():
            self.primitive_counts[name] += n
        self.callbacks.extend(child.callbacks)
        self.dynamic_loops.extend(child.dynamic_loops)
        self.conversions.extend(child.conversions)

    def summary(self) -> Dict[str, Any]:
        return {
            "path": self.path or "<root>",
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "intensity": self.intensity,
            "eqn_count": self.eqn_count,
            "by_kind": {k: dataclasses.asdict(v)
                        for k, v in self.by_kind.items() if v.count},
            "callbacks": list(self.callbacks),
            "dynamic_loops": list(self.dynamic_loops),
            "regions": {p: {"flops": r.flops, "hbm_bytes": r.hbm_bytes,
                            "trip_count": r.trip_count,
                            "intensity": r.intensity}
                        for p, r in self.regions.items()},
        }


def _subgraphs(node: torch.fx.Node, name: str, gm: Any
               ) -> List[Tuple[str, Any, float]]:
    """(tag, subgraph, trip count) for every subgraph of a higher-order
    node: ``scan`` multiplies by its length; ``while_loop`` bodies get trip
    count 1 (recorded separately as dynamic); ``cond`` is handled by the
    caller (max over branches); everything else recurses with trip 1."""
    subs = [_fetch(gm, a.target) for a in node.args
            if isinstance(a, torch.fx.Node) and a.op == "get_attr"]
    subs = [s for s in subs if isinstance(s, torch.fx.GraphModule)]
    if name == "scan" and subs:
        xs = _tensors(node.args[2:3], gm)
        length = int(xs[0].shape[0]) if xs else 1
        return [("scan[x%d]" % length, subs[0], float(length))]
    if name == "while_loop":
        return [("while.%s" % tag, sub, 1.0)
                for tag, sub in zip(("cond", "body"), subs)]
    return [("%s.%d" % (name, i) if len(subs) > 1 else name, sub, 1.0)
            for i, sub in enumerate(subs)]


def walk_graph(gm: torch.fx.GraphModule, *, path: str = "",
               _depth: int = 0) -> RegionReport:
    """Walk one traced graph recursively and return its RegionReport."""
    if _depth > 64:  # pathological nesting guard
        return RegionReport(path=path)
    report = RegionReport(path=path)
    for i, node in enumerate(gm.graph.nodes):
        # getitem unpacks a multi-output node's tuple: no op of its own
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        name = _op_name(node)
        kind = classify_primitive(name)
        ins = _tensors((node.args, node.kwargs), gm)
        if kind == CALLBACK and not _on_card(ins):
            kind = ELEMENTWISE  # a CPU tensor's: no device to wait for
        elif _host_copy(name, node, gm):
            kind = CALLBACK
        report.primitive_counts[name] += 1
        here = "%s/%s:%d" % (path, name, i) if path else "%s:%d" % (name, i)

        if kind == CALLBACK:
            report.callbacks.append(here)
        if name == "while_loop":
            report.dynamic_loops.append(here)
        out = _value(node, gm)
        outs = ([out] if isinstance(out, torch.Tensor) else
                [t for t in out if isinstance(t, torch.Tensor)]
                if isinstance(out, (list, tuple)) else [])
        if name == "_to_copy" and ins and outs \
                and outs[0].dtype != ins[0].dtype:
            report.conversions.append(
                (here, _dtype_name(ins[0].dtype), _dtype_name(outs[0].dtype),
                 _bytes(outs[0])))

        if name == "cond":
            reports = [walk_graph(sub, path=here + "/branch%d" % j,
                                  _depth=_depth + 1)
                       for j, (_, sub, _) in enumerate(
                           _subgraphs(node, name, gm))]
            if reports:
                worst = max(reports, key=lambda r: (r.flops, r.hbm_bytes))
                worst.trip_count = 1.0
                report.regions[here] = worst
                report.merge_child(worst, 1.0)
            report.by_kind[CONTROL].add(0.0, 0.0, 1.0)
            report.eqn_count += 1
            continue

        subs = (_subgraphs(node, name, gm)
                if isinstance(node.target, torch._ops.HigherOrderOperator)
                else [])
        if subs:
            for tag, sub, trips in subs:
                sub_path = "%s/%s" % (here, tag)
                child = walk_graph(sub, path=sub_path, _depth=_depth + 1)
                child.trip_count = trips
                report.regions[sub_path] = child
                report.merge_child(child, trips)
            report.by_kind[CONTROL].add(0.0, 0.0, 1.0)
            report.eqn_count += 1
            continue

        flops, nbytes = _node_cost(name, node, gm, ins, outs)
        report.by_kind[kind].add(flops, nbytes, 1.0)
        report.flops += flops
        report.hbm_bytes += nbytes
        report.eqn_count += 1
    return report


# ---------------------------------------------------------------------------
# Tracing on fake tensors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's stand-in: shape, dtype and device, no data (the
    counterpart of ``jax.ShapeDtypeStruct``). ``trace`` makes a fake tensor
    of it; the device defaults to the card."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    device: str = "cuda"


def fake_mode():
    """A ``FakeTensorMode`` in which ``.item()`` traces (it has a shape
    environment, so data-dependent scalars become symbols): make fake
    inputs under it for ``trace``, or let ``trace`` make its own."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    return FakeTensorMode(shape_env=ShapeEnv())


def _index_items(t: torch.Tensor, index: Any) -> Tuple[torch.Tensor, list]:
    """Apply an index's ints, slices, None and Ellipsis to ``t`` as
    PyTorch's ``__getitem__`` does, and return the view with the index's
    tensors aligned to its dims (None where an axis is whole)."""
    if not isinstance(index, tuple):
        index = (index,)
    for item in index:
        if isinstance(item, bool) or (isinstance(item, torch.Tensor)
                                      and item.dtype == torch.bool):
            raise NotImplementedError("boolean indices on a fake CUDA "
                                      "tensor without CUDA")
        if isinstance(item, (list, tuple)):
            raise NotImplementedError("sequence indices on a fake CUDA "
                                      "tensor without CUDA")
    consumed = sum(1 for item in index
                   if item is not None and item is not Ellipsis)
    out, dim, tensors = t, 0, []
    for item in index:
        if item is Ellipsis:
            n = t.dim() - consumed
            tensors.extend([None] * n)
            dim += n
        elif item is None:
            out = out.unsqueeze(dim)
            tensors.append(None)
            dim += 1
        elif isinstance(item, slice):
            out = torch.ops.aten.slice.Tensor(out, dim, item.start,
                                              item.stop, item.step or 1)
            tensors.append(None)
            dim += 1
        elif isinstance(item, torch.Tensor):
            tensors.append(item)
            dim += 1
        else:  # an int
            out = out.select(dim, item)
    return out, tensors


class _CudaBindings(TorchFunctionMode):
    """``[]``, ``copy_`` and ``contiguous`` on fake CUDA tensors where
    PyTorch has no CUDA (their bindings guard the device): each applied as
    the ops PyTorch's binding would dispatch."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.copy_ and args[0].is_cuda:
            return torch.ops.aten.copy_.default(*args, **kwargs)
        if func is torch.Tensor.contiguous and args[0].is_cuda:
            fmt = kwargs.get("memory_format", torch.contiguous_format)
            if args[0].is_contiguous(memory_format=fmt):
                return args[0]
            return torch.ops.aten.clone.default(args[0], memory_format=fmt)
        if func is torch.Tensor.__getitem__ and args[0].is_cuda:
            out, tensors = _index_items(args[0], args[1])
            if any(x is not None for x in tensors):
                return torch.ops.aten.index.Tensor(out, tensors)
            return out if out is not args[0] else out.alias()
        if func is torch.Tensor.__setitem__ and args[0].is_cuda:
            out, tensors = _index_items(args[0], args[1])
            value = args[2]
            if not isinstance(value, torch.Tensor):
                value = torch.full((), value, dtype=out.dtype,
                                   device=out.device)
            if any(x is not None for x in tensors):
                torch.ops.aten.index_put_(out, tensors,
                                          value.to(out.dtype))
            else:
                out.copy_(value)
            return None
        return func(*args, **kwargs)


def cuda_bindings():
    """A context in which fake CUDA tensors take ``[]``, ``copy_`` and
    ``contiguous`` on a build of PyTorch without CUDA (``_CudaBindings``);
    nothing to do on one with CUDA."""
    if torch.backends.cuda.is_built():
        return contextlib.nullcontext()
    return _CudaBindings()


@contextlib.contextmanager
def quiet_fake_pointers():
    """The kernel wrappers read a fake tensor's pointer (0) to tell it from
    a real one; PyTorch warns that the read is deprecated."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="Accessing the data pointer of FakeTensor")
        yield


def fake_leaves(leaves: List[Any]) -> List[Any]:
    """Fake tensors for ``leaves``' real tensors and ``TensorSpec``s, in
    the fake mode of their fake tensors if they hold any, else in a new
    ``fake_mode()``; fake tensors and other leaves as they are."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensor

    mode = detect_fake_mode([x for x in leaves
                             if isinstance(x, torch.Tensor)]) or fake_mode()

    def fake(x):
        if isinstance(x, FakeTensor):
            return x
        if isinstance(x, torch.Tensor):
            return mode.from_tensor(x)
        if isinstance(x, TensorSpec):
            return torch.empty(x.shape, dtype=x.dtype, device=x.device)
        return x

    with mode:
        return [fake(x) for x in leaves]


def trace(fn: Callable[..., Any], *args: Any,
          **kwargs: Any) -> torch.fx.GraphModule:
    """``make_fx`` the callable on fake tensors and return its graph.

    Args are trees (dicts, lists, tuples) of tensors, ``TensorSpec``s and
    constants. Fake tensors are traced in their own fake mode, real
    tensors and specs become fake ones (in ``fake_mode()`` unless the args
    hold fake tensors already); nothing runs on a device. The kernel
    wrappers add their launches as nodes (``kernels/_build.py``
    ``walking_graphs``)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils import _pytree

    from repro_torch.kernels._build import walking_graphs

    leaves, spec = _pytree.tree_flatten(args)
    leaves = fake_leaves(leaves)
    slots = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]

    def run(*tensors):
        full = list(leaves)
        for i, t in zip(slots, tensors):
            full[i] = t
        with cuda_bindings():
            return fn(*_pytree.tree_unflatten(full, spec), **kwargs)

    with quiet_fake_pointers(), walking_graphs():
        return make_fx(run, tracing_mode="fake")(
            *[leaves[i] for i in slots])


def trace_and_walk(fn: Callable[..., Any], *args: Any,
                   **kwargs: Any) -> RegionReport:
    """``trace`` the callable on the given args and walk its graph; no
    FLOP is executed."""
    return walk_graph(trace(fn, *args, **kwargs))
