"""The paper's contribution: power-aware automatic offloading.

GA search (ga, genome, fitness) + evaluation substrate (evaluator, with the
disk-persisted cache in cache_store) + power models (power) + unit-cost
models (arithmetic_intensity) + the LM verification environment
(lm_cost_model) + static narrowing (candidates) + runtime reconfiguration
(reconfigure) + mixed-environment selection (device_select) + the paper's
search entry point (offload_search.search_himeno) and the fleet sweeps with
their time/energy Pareto frontiers (offload_search.search_fleet, pareto).
The verification backends live in ``repro_torch.core.verifier``, which
imports the app and is not re-exported here.
"""
from repro_torch.core.fitness import (
    Measurement, TIMEOUT_SECONDS, UserRequirement, fitness,
)
from repro_torch.core.evaluator import (
    CacheStats, EvalCache, EvalEngine, SerialExecutor, ThreadedExecutor,
    VectorizedExecutor,
)
from repro_torch.core.cache_store import (
    CacheStore, PersistentEvalCache, measurement_from_json,
    measurement_to_json, stable_key,
)
from repro_torch.core.ga import GAConfig, GAResult, run_ga
from repro_torch.core.genome import Gene, GenomeSpace, binary_space
from repro_torch.core.power import (
    HardwareSpec, PaperPowerModel, RooflineTerms, TPU_V5E, TpuPowerModel,
)
from repro_torch.core.lm_cost_model import (
    Decisions, analyze_cell, canonical_decisions, cell_cache_key,
    measure_cell, measure_cell_batch,
)
from repro_torch.core.pareto import (
    ParetoPoint, dominates, fleet_frontier, frontier_by_cell, narrow,
    pareto_frontier, select_operating_point,
)
from repro_torch.core.offload_search import (
    CellSpec, FleetCellResult, FleetResult, lm_cell_key, lm_genome_space,
    mesh_label, search_fleet, search_himeno, search_lm_cell,
)
from repro_torch.core.candidates import NarrowingConfig, narrow_and_measure
from repro_torch.core.device_select import Destination, select_destination

__all__ = [
    "Measurement", "TIMEOUT_SECONDS", "UserRequirement", "fitness",
    "CacheStats", "EvalCache", "EvalEngine", "SerialExecutor",
    "ThreadedExecutor", "VectorizedExecutor",
    "CacheStore", "PersistentEvalCache", "measurement_from_json",
    "measurement_to_json", "stable_key",
    "GAConfig", "GAResult", "run_ga",
    "Gene", "GenomeSpace", "binary_space",
    "HardwareSpec", "PaperPowerModel", "RooflineTerms", "TPU_V5E",
    "TpuPowerModel",
    "Decisions", "analyze_cell", "canonical_decisions", "cell_cache_key",
    "measure_cell", "measure_cell_batch",
    "ParetoPoint", "dominates", "fleet_frontier", "frontier_by_cell",
    "narrow", "pareto_frontier", "select_operating_point",
    "CellSpec", "FleetCellResult", "FleetResult", "lm_cell_key",
    "lm_genome_space", "mesh_label", "search_fleet", "search_himeno",
    "search_lm_cell",
    "NarrowingConfig", "narrow_and_measure",
    "Destination", "select_destination",
]
