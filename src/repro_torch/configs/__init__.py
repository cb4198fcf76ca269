"""Configurations of the port's workloads: the Himeno grids and the
architecture registry (``base.py`` and ``archs.py``, copied from the JAX
package's ``configs/``)."""
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

__all__ = [
    "ArchConfig", "ShapeSpec", "SHAPES", "cell_supported", "get_config",
    "list_configs", "reduced", "register", "smoke_shape",
    "GRIDS", "PAPER_GRID", "PAPER_ITERS",
]
