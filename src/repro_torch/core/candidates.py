"""FPGA-path staged candidate narrowing (paper §3.2).

The target's compile is too expensive for iterated GA measurement, so:
  1. arithmetic-intensity filter (ROSE analogue)         — static
  2. trip-count filter (gcov/gprof analogue)             — static
  3. resource pre-check (FF/LUT → VMEM/HBM-fit analogue) — pre-compile
  4. measure the few survivors individually              — expensive
  5. combine winners, measure combinations once more     — expensive
Best short-time/low-energy pattern wins with the paper's fitness.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from repro_torch.core.arithmetic_intensity import UnitCost
from repro_torch.core.fitness import Measurement, fitness as fitness_fn


@dataclass
class NarrowingConfig:
    intensity_keep: int = 4     # keep top-N by arithmetic intensity
    tripcount_keep: int = 4     # keep top-N by trip count
    resource_limit: float = 16 * 2**20  # VMEM budget per kernel (bytes)
    max_measured: int = 6       # single-unit measurements allowed
    max_combinations: int = 4   # second-round combination measurements


@dataclass
class NarrowingReport:
    all_units: list[str]
    after_intensity: list[str]
    after_tripcount: list[str]
    after_resource: list[str]
    measured_single: dict[str, Measurement]
    measured_combos: dict[tuple[str, ...], Measurement]
    best_pattern: tuple[str, ...]
    best: Measurement


def narrow_and_measure(
    units: Sequence[UnitCost],
    measure_pattern: Callable[[tuple[str, ...]], Measurement],
    config: Optional[NarrowingConfig] = None,
) -> NarrowingReport:
    cfg = config or NarrowingConfig()
    offloadable = [u for u in units if u.parallel]

    # Stage 1: arithmetic intensity (descending), keep top-N
    by_ai = sorted(offloadable, key=lambda u: u.intensity, reverse=True)
    s1 = by_ai[: cfg.intensity_keep]
    # Stage 2: union with top trip counts (paper keeps both criteria)
    by_trip = sorted(offloadable, key=lambda u: (u.trip_count, u.total_flops),
                     reverse=True)
    s2_names = {u.name for u in s1} | {u.name for u in by_trip[: cfg.tripcount_keep]}
    s2 = [u for u in offloadable if u.name in s2_names]
    # Stage 3: resource pre-check (pre-compile FF/LUT analogue)
    s3 = [u for u in s2 if u.vmem_bytes <= cfg.resource_limit]

    # Stage 4: measure single-unit patterns (most promising first)
    s3_sorted = sorted(s3, key=lambda u: u.total_flops, reverse=True)
    singles: dict[str, Measurement] = {}
    for u in s3_sorted[: cfg.max_measured]:
        singles[u.name] = measure_pattern((u.name,))

    # Stage 5: combine units that beat the all-CPU baseline, re-measure
    baseline = measure_pattern(())
    improved = [n for n, m in singles.items()
                if m.feasible and not m.timed_out
                and fitness_fn(m) > fitness_fn(baseline)]
    combos: dict[tuple[str, ...], Measurement] = {}
    if len(improved) >= 2:
        ordered = sorted(improved,
                         key=lambda n: fitness_fn(singles[n]), reverse=True)
        cands = []
        for k in range(2, len(ordered) + 1):
            cands.append(tuple(ordered[:k]))
        for pattern in cands[: cfg.max_combinations]:
            combos[pattern] = measure_pattern(pattern)

    # Pick best (paper's same scoring formula)
    scored: list[tuple[tuple[str, ...], Measurement]] = [((), baseline)]
    scored += [((n,), m) for n, m in singles.items()]
    scored += list(combos.items())
    best_pattern, best = max(scored, key=lambda kv: fitness_fn(kv[1]))

    return NarrowingReport(
        all_units=[u.name for u in offloadable],
        after_intensity=[u.name for u in s1],
        after_tripcount=[u.name for u in s2],
        after_resource=[u.name for u in s3],
        measured_single=singles,
        measured_combos=combos,
        best_pattern=best_pattern,
        best=best,
    )
