"""Static analysis ahead of measurement.

:mod:`repro_torch.analysis.screen` is the static pre-screen ``search_fleet``
runs before measuring: statically-dominated / resource-infeasible /
below-intensity-floor cells never reach the GA's verification environment,
and the measurements avoided are reported. The JAX package's other layers
here (the jaxpr walker, the offload and kernel lints, the race lint) wait
for a later slice of the port.
"""
from repro_torch.analysis.screen import (  # noqa: F401
    CellStatics, ScreenPolicy, ScreenReport, screen_cells,
)

__all__ = ["CellStatics", "ScreenPolicy", "ScreenReport", "screen_cells"]
