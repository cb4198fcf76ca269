"""Per-(arch, shape, mesh) sharding layout policy.

Counterpart of the JAX package's ``parallel/layouts.py``. ``rules_for``
produces the baseline ShardingRules for a cell; the offload genome mutates
the returned table (sharding-axis genes), the paper's "which device group
runs this region" decision surface. Pure Python over the mesh's axis
sizes: a ``DeviceMesh`` or the reference tests' stand-in (``axis_names``
and ``devices.shape``) serves alike.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.parallel.sharding import (
    DEFAULT_RULES, ShardingRules, _mesh_axis_sizes,
)


def _axis_size(mesh, name: str) -> int:
    return _mesh_axis_sizes(mesh).get(name, 1)


def rules_for(
    cfg: ArchConfig,
    shape: ShapeSpec,
    mesh,
    overrides: Optional[dict] = None,
) -> ShardingRules:
    tp = _axis_size(mesh, "model")
    rules = ShardingRules(dict(DEFAULT_RULES))

    upd: dict = {}
    # KV heads shard over model when divisible (MHA-ish archs).
    if cfg.num_kv_heads and cfg.num_kv_heads % tp == 0:
        upd["kv_heads"] = "model"
        upd["act_kv_heads"] = "model"

    # Heads not divisible by the model axis fall back to replicated
    # attention via spec pruning; for prefill, attention internals shard
    # over the query sequence instead.
    if (cfg.num_heads and cfg.num_heads % tp != 0
            and shape.kind == "prefill" and shape.seq_len % tp == 0):
        upd["seq_inner"] = "model"

    if shape.kind == "decode":
        # flash-decode: batch over data(+pod); KV sequence over model.
        upd["batch"] = ("pod", "data")
        upd["kv_seq"] = "model"
        upd["act_kv_heads"] = None  # cache is seq-sharded instead
        if shape.global_batch == 1:
            # long-context single-stream: spread KV over every axis.
            upd["kv_seq"] = ("data", "model")
        # decode attention reads the seq-sharded cache with replicated heads
        upd["act_heads"] = None
    else:
        upd["batch"] = ("pod", "data")
        # Sequence parallelism of the residual stream between blocks.
        if shape.seq_len % tp == 0:
            upd["seq"] = "model"

    if overrides:
        upd.update(overrides)
    return rules.with_overrides(**upd)
