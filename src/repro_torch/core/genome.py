"""Offload genomes.

The paper's GPU genome is a bit per parallelizable loop (1 = offload).
Generalized here to categorical genes so the same GA searches TPU execution
decisions (remat policy, attention impl, sharding axes, overlap schedule).
Inapplicable genes for an architecture are *masked out* at space-construction
time (DESIGN.md §Arch-applicability) rather than carried as dead bits.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Sequence


@dataclass(frozen=True)
class Gene:
    name: str
    choices: tuple[Any, ...]

    def __post_init__(self):
        assert len(self.choices) >= 1, self.name


@dataclass(frozen=True)
class GenomeSpace:
    genes: tuple[Gene, ...]

    @property
    def size(self) -> int:
        n = 1
        for g in self.genes:
            n *= len(g.choices)
        return n

    def random(self, rng: random.Random) -> tuple[int, ...]:
        return tuple(rng.randrange(len(g.choices)) for g in self.genes)

    def zeros(self) -> tuple[int, ...]:
        return tuple(0 for _ in self.genes)

    def decode(self, genome: Sequence[int]) -> dict[str, Any]:
        assert len(genome) == len(self.genes)
        return {g.name: g.choices[i] for g, i in zip(self.genes, genome)}

    def encode(self, assignment: dict[str, Any]) -> tuple[int, ...]:
        out = []
        for g in self.genes:
            out.append(g.choices.index(assignment[g.name]) if g.name in assignment
                       else 0)
        return tuple(out)

    # --- GA operators (paper §4.1.2) ---------------------------------------
    def crossover(self, a: Sequence[int], b: Sequence[int],
                  rng: random.Random) -> tuple[tuple[int, ...], tuple[int, ...]]:
        """Single-point crossover."""
        if len(self.genes) < 2:
            return tuple(a), tuple(b)
        pt = rng.randrange(1, len(self.genes))
        return tuple(a[:pt]) + tuple(b[pt:]), tuple(b[:pt]) + tuple(a[pt:])

    def mutate(self, g: Sequence[int], pm: float, rng: random.Random
               ) -> tuple[int, ...]:
        out = list(g)
        for i, gene in enumerate(self.genes):
            if rng.random() < pm and len(gene.choices) > 1:
                cur = out[i]
                alt = rng.randrange(len(gene.choices) - 1)
                out[i] = alt if alt < cur else alt + 1
        return tuple(out)


def binary_space(names: Sequence[str]) -> GenomeSpace:
    """The paper's literal genome: one CPU(0)/device(1) bit per loop."""
    return GenomeSpace(tuple(Gene(n, (0, 1)) for n in names))
