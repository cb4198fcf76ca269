"""The port's graph walker (``repro_torch.analysis.graph_walk``) on the CPU.

The JAX package's jaxpr walker does not trace on this JAX (its cases in
``tests/test_analysis.py`` fail), so the port is held, case for case, to
the numbers those tests compute by hand: the product's flops and unfused
bytes, ``scan``'s trip count, ``cond``'s worst branch, ``while`` flagged
dynamic, a host sync classified and linted. Every function is traced on
fake tensors on the card (``TensorSpec`` defaults to "cuda"), which this
build of PyTorch cannot run: nothing runs.

Also: the classification buckets against the reference's own
``classify_primitive`` on each counterpart name; ``[]`` on fake CUDA
tensors (applied as PyTorch's ops where PyTorch has no CUDA) against
PyTorch's own indexing; the kernels as ``kernel`` nodes with the launches
a decode step makes (PERF.md §3); and the consistency property between
traced costs and ``core/arithmetic_intensity.py`` ``lm_unit_costs``.
"""
import pytest
import torch
from torch._higher_order_ops.scan import scan
from torch._higher_order_ops.while_loop import while_loop

from _hypothesis_compat import given, settings, st
from repro_torch.analysis import graph_walk
from repro_torch.analysis.graph_walk import (TensorSpec, classify_primitive,
                                             trace_and_walk)
from repro_torch.analysis.offload_lint import (_decode_shapes, fake_model,
                                               lint_graph_hazards)
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec, reduced
from repro_torch.core.arithmetic_intensity import lm_unit_costs
from repro_torch.models import transformer as T


def test_matmul_flops_exact():
    rep = trace_and_walk(lambda x, y: x @ y, TensorSpec((8, 32)),
                         TensorSpec((32, 16)))
    assert rep.by_kind["matmul"].flops == 2 * 8 * 16 * 32
    # bytes: unfused in+out charge for the single node
    assert rep.by_kind["matmul"].bytes == (8 * 32 + 32 * 16 + 8 * 16) * 4
    assert rep.flops == 2 * 8 * 16 * 32


def test_scan_trip_count_multiplies():
    def fn(x, w, xs):
        def body(carry, _):
            return carry @ w, carry.clone()
        out, _ = scan(body, x, xs)
        return out

    rep = trace_and_walk(fn, TensorSpec((4, 16)), TensorSpec((16, 16)),
                         TensorSpec((5, 1)))
    assert rep.flops == 5 * (2 * 4 * 16 * 16)
    (region,) = [r for p, r in rep.regions.items() if "scan" in p]
    assert region.trip_count == 5
    assert region.flops == 2 * 4 * 16 * 16  # per-trip body cost
    assert [p.rsplit("/", 1)[1] for p in rep.regions] == ["scan[x5]"]


def test_cond_charges_worst_branch():
    def fn(pred, x):
        return torch.cond(pred, lambda v: v @ v @ v, lambda v: v.clone(),
                          (x,))

    rep = trace_and_walk(fn, TensorSpec((), torch.bool), TensorSpec((8, 8)))
    assert rep.by_kind["matmul"].flops == 2 * (2 * 8 * 8 * 8)  # two matmuls


def test_while_flagged_dynamic():
    def fn(x):
        return while_loop(lambda v: v.sum() < 10.0, lambda v: (v + 1.0,),
                          (x,))

    rep = trace_and_walk(fn, TensorSpec((4,)))
    assert rep.dynamic_loops
    findings = lint_graph_hazards(rep, site="t")
    assert any(f.rule == "dynamic-loop" and f.severity == "info"
               for f in findings)


@pytest.mark.parametrize("sync", ["item", "cpu"])
def test_host_sync_classified_and_linted(sync):
    """``.item()`` and ``.cpu()`` of a tensor on the card each wait for the
    card: a callback node, a ``host-sync`` error."""
    def fn(x):
        if sync == "item":
            return x.sum().item()
        return x.cpu() + 1

    rep = trace_and_walk(fn, TensorSpec((4,)))
    assert len(rep.callbacks) == 1 and rep.by_kind["callback"].count == 1
    findings = lint_graph_hazards(rep, site="t")
    assert [(f.rule, f.severity) for f in findings] == [("host-sync",
                                                         "error")]


def test_cpu_tensors_never_sync():
    """The same on CPU tensors waits for nothing."""
    rep = trace_and_walk(lambda x: (x.cpu() + 1, x.sum().item()),
                         TensorSpec((4,), device="cpu"))
    assert rep.callbacks == []


# each port name beside the name its counterpart has in a jaxpr
_COUNTERPARTS = [
    ("mm", "dot_general"), ("convolution", "conv_general_dilated"),
    ("scatter_add", "scatter-add"), ("index_put_", "scatter"),
    ("gather", "gather"), ("sort", "sort"),
    ("_c10d_functional.all_reduce", "psum"),
    ("c10d_functional.all_gather_into_tensor", "all_gather"),
    ("_local_scalar_dense", "pure_callback"), ("rms_norm", "pallas_call"),
    ("wkv_backward", "pallas_call"), ("cond", "cond"),
    ("while_loop", "while"), ("scan", "scan"), ("exp", "exp"),
    ("sum", "reduce_sum"), ("view", "reshape"), ("_to_copy",
                                                 "convert_element_type"),
]


@pytest.mark.parametrize("port,ref", _COUNTERPARTS)
def test_classification_buckets(port, ref):
    from repro.analysis import jaxpr_walk

    assert classify_primitive(port) == jaxpr_walk.classify_primitive(ref)


def test_classification_names():
    assert classify_primitive("mm") == "matmul"
    assert classify_primitive("scatter_add") == "scatter"
    assert classify_primitive("_c10d_functional.all_reduce") == "collective"
    assert classify_primitive("_local_scalar_dense") == "callback"
    assert classify_primitive("flash_attention") == "kernel"
    assert classify_primitive("exp") == "elementwise"
    assert classify_primitive("while_loop") == "control"


_INDICES = [
    (2,), (slice(None), 1), (Ellipsis, None), (Ellipsis, None, slice(1, 3)),
    (slice(None), None, None), (None, slice(1, None)), (slice(None, -1),),
    (Ellipsis, 0), (slice(None), slice(1, 2), None, None),
    (torch.tensor([0, 2]), torch.tensor([1, 0], dtype=torch.int32)),
    (slice(None), torch.tensor([[0, 1]])), (1, slice(None, None, 2)),
]


@pytest.mark.parametrize("index", _INDICES, ids=range(len(_INDICES)))
def test_cuda_indexing_matches_pytorch(index):
    """Indexing applied as PyTorch's ops (what ``trace`` does on fake CUDA
    tensors where PyTorch has no CUDA) gives PyTorch's own result: values
    on real CPU tensors, and the same write through ``__setitem__``."""
    x = torch.arange(3 * 4 * 5, dtype=torch.float32).reshape(3, 4, 5)
    want = x[index]
    with graph_walk._CudaBindings():
        out, tensors = graph_walk._index_items(x, index)
        got = (torch.ops.aten.index.Tensor(out, tensors)
               if any(t is not None for t in tensors) else out)
    assert got.shape == want.shape and torch.equal(got, want)
    a, b = x.clone(), x.clone()
    a[index] = -1.0
    out, tensors = graph_walk._index_items(b, index)
    if any(t is not None for t in tensors):
        torch.ops.aten.index_put_(out, tensors, torch.tensor(-1.0))
    else:
        out.copy_(torch.tensor(-1.0))
    assert torch.equal(a, b)


def _decode_report(arch, batch=2, cache_len=64):
    cfg = reduced(get_config(arch))
    mode = graph_walk.fake_mode()
    model = fake_model(cfg, mode)
    state, tokens = _decode_shapes(cfg, batch, cache_len, mode)
    return cfg, trace_and_walk(
        lambda s, t: T.decode_step(cfg, model, s, t), state, tokens)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-1.6b", "zamba2-7b"])
def test_kernels_are_nodes_with_their_launches(arch):
    """A decode step's kernel launches are ``kernel`` nodes, as many as
    PERF.md §3 counts a decode step (B2: 2n+1 dense and RWKV, groups + n +
    1 hybrid; B4: n), each charged its module's ``cost``."""
    from repro_torch.kernels.rmsnorm.kernel import cost as rms_cost
    from repro_torch.kernels.wkv.kernel import cost as wkv_cost

    cfg, rep = _decode_report(arch)
    n = cfg.num_layers
    groups = T.hybrid_groups(cfg)[0] if cfg.family == "hybrid" else 0
    want = {"rms_norm": groups + n + 1 if groups else 2 * n + 1}
    if cfg.family == "ssm":
        want["wkv"] = n
    kernels = {k: v for k, v in rep.primitive_counts.items()
               if classify_primitive(k) == "kernel"}
    assert kernels == want
    flops = want["rms_norm"] * rms_cost((2, 1, cfg.d_model), 2)[0]
    if "wkv" in want:
        h, d = cfg.rwkv_heads, cfg.rwkv_head_size
        flops += n * wkv_cost(2, h, 1, d, True)[0]
    assert rep.by_kind["kernel"].count == sum(want.values())
    assert rep.by_kind["kernel"].flops == flops


# Stated tolerances (the reference's, documented in graph_walk's module
# docstring): traced FLOPs track the config model within ±10%; traced bytes
# are an UNFUSED upper bound, so they must be >= ~the unit estimate and
# within a bounded constant of it. Measured spread on the port (this file's
# archs at batch 1-4, seq 32/64/128): FLOPs 1.006-1.021, bytes 1.93-13.24.
_FLOPS_BAND = (0.90, 1.10)
_BYTES_BAND = (0.95, 16.0)


@settings(max_examples=12, deadline=None)
@given(arch=st.sampled_from(("llama3.2-3b", "rwkv6-1.6b", "zamba2-7b")),
       batch=st.integers(1, 4),
       seq_len=st.sampled_from((32, 64, 128)))
def test_traced_costs_match_unit_costs(arch, batch, seq_len):
    cfg = reduced(get_config(arch))
    shape = ShapeSpec("cell", "decode", seq_len, batch)
    units = lm_unit_costs(cfg, shape)
    unit_flops = sum(u.total_flops for u in units)
    unit_bytes = sum(u.total_bytes for u in units)
    _, rep = _decode_report(arch, batch, seq_len)

    flops_ratio = rep.flops / unit_flops
    bytes_ratio = rep.hbm_bytes / unit_bytes
    assert _FLOPS_BAND[0] <= flops_ratio <= _FLOPS_BAND[1], \
        f"{arch} B={batch} S={seq_len}: flops ratio {flops_ratio:.3f}"
    assert _BYTES_BAND[0] <= bytes_ratio <= _BYTES_BAND[1], \
        f"{arch} B={batch} S={seq_len}: bytes ratio {bytes_ratio:.3f}"
