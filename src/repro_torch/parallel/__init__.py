"""Parameter definitions (``sharding.py``). The port runs on one card with
no mesh, so it keeps only what builds parameters."""
from repro_torch.parallel.sharding import PDef, init_from_defs, stack_defs

__all__ = ["PDef", "init_from_defs", "stack_defs"]
