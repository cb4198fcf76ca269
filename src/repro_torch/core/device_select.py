"""Mixed-environment offload-destination selection (paper §3.3).

Candidate destinations are verified in *cheap-to-expensive* order
(many-core CPU → GPU → FPGA in the paper; analytic → single-pod compile →
multi-pod compile here). Verification stops early once the user requirement
is satisfied; otherwise every destination is scored with the same
(time)^(-1/2)·(energy)^(-1/2) formula and the best wins.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from repro_torch.core.fitness import (
    Measurement, UserRequirement, fitness as fitness_fn,
)


@dataclass(frozen=True)
class Destination:
    """One offload target with its verification cost (paper: FPGA compiles
    take hours, GPU minutes, many-core CPU almost nothing)."""

    name: str
    verify_cost_s: float
    search: Callable[[], tuple[object, Measurement]]  # -> (pattern, best meas.)


@dataclass
class SelectionReport:
    order: list[str]
    verified: dict[str, Measurement]
    patterns: dict[str, object]
    skipped: list[str]
    chosen: Optional[str]
    early_exit: bool
    verification_spent_s: float


def select_destination(
    destinations: Sequence[Destination],
    requirement: Optional[UserRequirement] = None,
) -> SelectionReport:
    ordered = sorted(destinations, key=lambda d: d.verify_cost_s)
    verified: dict[str, Measurement] = {}
    patterns: dict[str, object] = {}
    spent = 0.0
    early = False

    satisfier: Optional[str] = None
    for i, dest in enumerate(ordered):
        pattern, meas = dest.search()
        verified[dest.name] = meas
        patterns[dest.name] = pattern
        spent += dest.verify_cost_s
        if requirement is not None and requirement.satisfied(meas):
            early = True  # paper: later (more expensive) targets not verified
            satisfier = dest.name
            break

    remaining = [d.name for d in ordered if d.name not in verified]
    valid = {n: m for n, m in verified.items()
             if m.feasible and not m.timed_out}
    if satisfier is not None:
        # §3.3 early exit ADOPTS the destination that satisfied the
        # requirement: cheaper targets verified on the way there may score a
        # higher fitness, but they failed the requirement — a max(fitness)
        # over everything verified so far would silently override the
        # satisfying destination (the pre-PR-2 bug).
        chosen: Optional[str] = satisfier
    else:
        # full verification (no requirement, or nothing satisfied it): every
        # destination scored with the paper's fitness, best wins.
        chosen = (max(valid, key=lambda n: fitness_fn(valid[n]))
                  if valid else None)
    return SelectionReport(
        order=[d.name for d in ordered],
        verified=verified,
        patterns=patterns,
        skipped=remaining,
        chosen=chosen,
        early_exit=early,
        verification_spent_s=spent,
    )
