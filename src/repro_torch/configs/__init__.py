"""Problem sizes of the port's workloads (the Himeno grids for now)."""
from repro_torch.configs.himeno import GRIDS, PAPER_GRID, PAPER_ITERS

__all__ = ["GRIDS", "PAPER_GRID", "PAPER_ITERS"]
