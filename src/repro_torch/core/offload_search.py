"""GA offload search for the paper's workload.

``search_himeno`` is the paper's literal experiment: a 13-bit genome over
Himeno's loop statements, scored by a measured or calibrated backend. The
GA runs its own deterministic RNG stream and every backend is a function of
the genome, so the search is reproducible for a given seed.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.ga import GAConfig, GAResult, run_ga
from repro_torch.core.genome import binary_space


def search_himeno(backend, config: Optional[GAConfig] = None) -> GAResult:
    """backend: HimenoMeasuredBackend or HimenoCalibratedBackend."""
    names = backend.unit_names()
    space = binary_space(names)
    cfg = config or GAConfig(population=min(12, len(names)),
                             generations=min(12, len(names)))
    return run_ga(space, lambda bits: backend.measure_bits(bits), cfg,
                  seed_genomes=(space.zeros(),))
