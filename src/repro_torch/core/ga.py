"""The paper's genetic algorithm (§3.1, §4.1.2), exactly parameterized:

  population M ≤ #genes, generations T ≤ #genes, roulette-wheel selection
  with elitism (best individual copied unchanged), crossover Pc = 0.9,
  mutation Pm = 0.05, timeout → 10 000 s penalty, each distinct pattern
  measured once (verification-environment results are cached).

Evaluation is routed through a pluggable :class:`~repro_torch.core.evaluator.
EvalEngine`: each generation's genomes are deduplicated against the engine's
(persistent, possibly cross-cell) cache and the uncached remainder is
dispatched as one batch to the engine's executor. The default engine (serial
executor, private cache) reproduces the seed behavior bit-for-bit; results
are identical for every executor because measurement backends are pure and
the GA's RNG stream never observes the executor.
"""
from __future__ import annotations

import itertools
import random
from dataclasses import dataclass
from typing import Callable, Hashable, Optional

from repro_torch.core.evaluator import EvalEngine
from repro_torch.core.fitness import Measurement, fitness as fitness_fn
from repro_torch.core.genome import GenomeSpace


@dataclass
class GAConfig:
    population: int = 12
    generations: int = 12
    crossover_rate: float = 0.9  # Pc (paper)
    mutation_rate: float = 0.05  # Pm (paper)
    elitism: int = 1  # elite preservation (paper)
    seed: int = 0
    time_exp: float = -0.5
    energy_exp: float = -0.5


@dataclass
class EvalRecord:
    genome: tuple[int, ...]
    measurement: Measurement
    fitness: float


@dataclass
class GAResult:
    best: EvalRecord
    history: list[list[EvalRecord]]  # per generation
    evaluations: int  # distinct verification-environment measurements
    cache_hits: int


# Anonymous runs each get a unique cell label: two default-keyed run_ga calls
# sharing one engine must never read each other's cached measurements (their
# genome tuples can collide across unrelated spaces).
_ANON_CELLS = itertools.count()


def run_ga(
    space: GenomeSpace,
    measure: Callable[[tuple[int, ...]], Measurement],
    config: Optional[GAConfig] = None,
    *,
    seed_genomes: tuple[tuple[int, ...], ...] = (),
    on_generation: Optional[Callable[[int, list[EvalRecord]], None]] = None,
    engine: Optional[EvalEngine] = None,
    cell: Optional[str] = None,
    canonical: Optional[Callable[[tuple[int, ...]], Hashable]] = None,
) -> GAResult:
    """``engine``/``cell``/``canonical`` plug the run into a shared batched
    evaluation substrate (see evaluator.py); omitted, the run gets a private
    serial engine with the classic per-run cache. Cross-run cache sharing
    requires an explicit ``cell`` (or ``canonical``): anonymous runs are
    keyed uniquely so unrelated searches can share an engine safely."""
    cfg = config or GAConfig()
    rng = random.Random(cfg.seed)
    eng = engine or EvalEngine()
    if cell is None:
        cell = f"ga#{next(_ANON_CELLS)}"
    stats = {"evals": 0, "hits": 0}

    def evaluate_generation(pop: list[tuple[int, ...]]) -> list[EvalRecord]:
        ms, evals, hits = eng.evaluate(cell, pop, measure, canonical=canonical)
        stats["evals"] += evals
        stats["hits"] += hits
        return [
            EvalRecord(g, m, fitness_fn(
                m, time_exp=cfg.time_exp, energy_exp=cfg.energy_exp))
            for g, m in zip(pop, ms)
        ]

    # --- initial population --------------------------------------------------
    pop: list[tuple[int, ...]] = list(seed_genomes)[: cfg.population]
    seen = set(pop)
    while len(pop) < cfg.population:
        g = space.random(rng)
        if g not in seen or len(seen) >= space.size:
            pop.append(g)
            seen.add(g)

    history: list[list[EvalRecord]] = []
    best: Optional[EvalRecord] = None

    for gen in range(cfg.generations):
        records = evaluate_generation(pop)
        records.sort(key=lambda r: r.fitness, reverse=True)
        history.append(records)
        if best is None or records[0].fitness > best.fitness:
            best = records[0]
        if on_generation:
            on_generation(gen, records)
        if gen == cfg.generations - 1:
            break

        # --- roulette-wheel selection (fitness-proportional) -----------------
        total = sum(r.fitness for r in records)

        def pick() -> tuple[int, ...]:
            if total <= 0:
                return records[rng.randrange(len(records))].genome
            x = rng.random() * total
            acc = 0.0
            for r in records:
                acc += r.fitness
                if acc >= x:
                    return r.genome
            return records[-1].genome

        next_pop: list[tuple[int, ...]] = [
            r.genome for r in records[: cfg.elitism]]  # elite preserved as-is
        while len(next_pop) < cfg.population:
            a, b = pick(), pick()
            if rng.random() < cfg.crossover_rate:
                a, b = space.crossover(a, b, rng)
            a = space.mutate(a, cfg.mutation_rate, rng)
            next_pop.append(a)
            if len(next_pop) < cfg.population:
                b = space.mutate(b, cfg.mutation_rate, rng)
                next_pop.append(b)
        pop = next_pop

    assert best is not None
    return GAResult(best=best, history=history,
                    evaluations=stats["evals"], cache_hits=stats["hits"])
