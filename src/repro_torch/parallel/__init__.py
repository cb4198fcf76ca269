"""Logical-axis sharding on a ``DeviceMesh`` (``sharding.py``), the layout
policy (``layouts.py``) and the GPipe pipeline (``pipeline.py``)."""
from repro_torch.parallel.sharding import (
    NamedSharding,
    PDef,
    ShardingRules,
    init_from_defs,
    named_sharding,
    shard_act,
    shardings_from_defs,
    specs_from_defs,
    stack_defs,
    use_mesh,
)
from repro_torch.parallel.layouts import rules_for

__all__ = [
    "NamedSharding",
    "PDef",
    "ShardingRules",
    "init_from_defs",
    "named_sharding",
    "shard_act",
    "shardings_from_defs",
    "specs_from_defs",
    "stack_defs",
    "use_mesh",
    "rules_for",
]
