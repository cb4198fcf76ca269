"""Static analysis ahead of measurement.

* :mod:`repro_torch.analysis.screen` — the static pre-screen
  ``search_fleet`` runs before measuring: statically-dominated /
  resource-infeasible / below-intensity-floor cells never reach the GA's
  verification environment, and the measurements avoided are reported.
* :mod:`repro_torch.analysis.concurrency` — the AST race/deadlock lint over
  the port's own runtime (shared-state map from thread entry points,
  lock-discipline inference, lock-ordering cycles, blocking-under-lock),
  with its finding type from :mod:`repro_torch.analysis.offload_lint`.

The JAX package's trace-based layers here (the jaxpr walker, the rest of
the offload lint, the kernel lint) wait for a later slice of the port.
"""
from repro_torch.analysis.concurrency import (  # noqa: F401
    ConcurrencyReport, SharedAttr, lint_runtime, lint_scan, scan_paths,
    scan_source,
)
from repro_torch.analysis.offload_lint import Finding  # noqa: F401
from repro_torch.analysis.screen import (  # noqa: F401
    CellStatics, ScreenPolicy, ScreenReport, screen_cells,
)

__all__ = ["CellStatics", "ConcurrencyReport", "Finding", "ScreenPolicy",
           "ScreenReport", "SharedAttr", "lint_runtime", "lint_scan",
           "scan_paths", "scan_source", "screen_cells"]
