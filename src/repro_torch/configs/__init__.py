"""Configurations of the port's workloads: the Himeno grids, the
architecture registry (``base.py`` and ``archs.py``) and the catalog of
offload destinations (``destinations.py``), copied from the JAX package's
``configs/``."""
from repro_torch.configs.base import (
    SHAPES,
    ArchConfig,
    ShapeSpec,
    cell_supported,
    get_config,
    list_configs,
    reduced,
    register,
    smoke_shape,
)
from repro_torch.configs.himeno import GRIDS, PAPER_GRID, PAPER_ITERS

# Imported last: destinations pulls in repro_torch.core.power, which
# initializes the core package — keep it below the base re-exports so core
# modules importing repro_torch.configs.base never see a partial package.
from repro_torch.configs.destinations import (
    DESTINATIONS, DestinationSpec, calibrated_catalog, mixed_fleet,
)

__all__ = [
    "ArchConfig", "ShapeSpec", "SHAPES", "cell_supported", "get_config",
    "list_configs", "reduced", "register", "smoke_shape",
    "GRIDS", "PAPER_GRID", "PAPER_ITERS",
    "DESTINATIONS", "DestinationSpec", "calibrated_catalog", "mixed_fleet",
]
