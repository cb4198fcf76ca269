"""The paper's contribution: power-aware automatic offloading.

GA search (ga, genome, fitness) + evaluation substrate (evaluator, with the
disk-persisted cache in cache_store) + power models (power) + the Himeno
unit-cost model (arithmetic_intensity) + the paper's search entry point
(offload_search.search_himeno). The verification backends live in
``repro_torch.core.verifier``, which imports the app and is not re-exported
here.
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
from repro_torch.core.offload_search import search_himeno

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
    "search_himeno",
]
