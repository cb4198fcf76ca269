"""Static analysis over traced FX graphs and CUDA launches (offload-lint),
and the pre-screen.

Counterpart of the JAX package's ``analysis/``. The paper's pipeline
*starts* with static code analysis: loop statements are parsed and
classified before any GA measurement narrows them further. This package is
that stage for the PyTorch/CUDA port:

* :mod:`repro_torch.analysis.graph_walk` — trace a function on fake tensors
  (``make_fx``) and walk its FX graph (including the subgraphs of ``scan``,
  ``while_loop`` and ``cond``), classify every node and derive per-region
  FLOPs, HBM-byte proxies, arithmetic intensity and trip counts; the
  counterpart of the jaxpr walker.
* :mod:`repro_torch.analysis.offload_lint` /
  :mod:`repro_torch.analysis.kernel_lint` — findings with severity and
  stable IDs for serving-hot-path hazards (host syncs, decode state not
  updated in place, f32 promotions, retrace hazards) and for the CUDA
  launches of the four kernels (grid coverage, tiles past an operand,
  threads and shared memory against the card's limits), with their CLI
  gate, ``python -m repro_torch.analysis.offload_lint``.
* :mod:`repro_torch.analysis.screen` — the static pre-screen
  ``search_fleet`` runs before measuring: statically-dominated /
  resource-infeasible / below-intensity-floor cells never reach the GA's
  verification environment, and the measurements avoided are reported.
* :mod:`repro_torch.analysis.concurrency` — the AST race/deadlock lint over
  the port's own runtime (shared-state map from thread entry points,
  lock-discipline inference, lock-ordering cycles, blocking-under-lock).

The names follow the reference's but where they name a JAX or Pallas
object: ``walk_graph`` (``walk_closed``), ``lint_graph_hazards``
(``lint_jaxpr_hazards``), ``CapturedLaunch`` (``CapturedCall``),
``capture_launches`` (``capture_pallas_calls``).
"""
from repro_torch.analysis.graph_walk import (  # noqa: F401
    EqnStats, RegionReport, classify_primitive, trace_and_walk, walk_graph,
)
from repro_torch.analysis.offload_lint import (  # noqa: F401
    Finding, lint_decode_family, lint_graph_hazards, lint_model_families,
)
from repro_torch.analysis.kernel_lint import (  # noqa: F401
    CapturedLaunch, capture_launches, lint_captured, lint_kernel_families,
)
from repro_torch.analysis.screen import (  # noqa: F401
    CellStatics, ScreenPolicy, ScreenReport, screen_cells,
)
from repro_torch.analysis.concurrency import (  # noqa: F401
    ConcurrencyReport, SharedAttr, lint_runtime, lint_scan, scan_paths,
    scan_source,
)

__all__ = ["CapturedLaunch", "CellStatics", "ConcurrencyReport", "EqnStats",
           "Finding", "RegionReport", "ScreenPolicy", "ScreenReport",
           "SharedAttr", "capture_launches", "classify_primitive",
           "lint_captured", "lint_decode_family", "lint_graph_hazards",
           "lint_kernel_families", "lint_model_families", "lint_runtime",
           "lint_scan", "scan_paths", "scan_source", "screen_cells",
           "trace_and_walk", "walk_graph"]
