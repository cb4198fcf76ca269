"""Time-vs-energy Pareto frontiers over verification-environment measurements.

The paper's Fig.5 compares a *single* operating point (the GA winner's
Watt·seconds) against the CPU-only baseline. A fleet sweep produces many
measured patterns per cell; the natural generalization is the non-dominated
frontier in the (processing time, energy) plane: every point on it is a
defensible operating choice, and ``UserRequirement`` (§3.3) narrows the
frontier to the points a user would accept — then one is picked by policy
(lowest energy, lowest time, or the paper's fitness).

Timed-out and infeasible measurements never enter a frontier: the paper's
10 000 s penalty exists to steer the GA, not to describe a runnable
operating point.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence

from repro_torch.core.fitness import Measurement, UserRequirement, fitness


@dataclass(frozen=True)
class ParetoPoint:
    """One measured operating point; ``cell`` labels its fleet cell."""

    genome: tuple[int, ...]
    measurement: Measurement
    cell: str = ""

    @property
    def time_s(self) -> float:
        return self.measurement.time_s

    @property
    def energy_ws(self) -> float:
        return self.measurement.energy_ws

    @property
    def fitness(self) -> float:
        return fitness(self.measurement)


def dominates(a: Measurement, b: Measurement) -> bool:
    """True iff ``a`` is no worse than ``b`` in both time and energy and
    strictly better in at least one (minimization)."""
    return (a.time_s <= b.time_s and a.energy_ws <= b.energy_ws
            and (a.time_s < b.time_s or a.energy_ws < b.energy_ws))


def _runnable(p: ParetoPoint) -> bool:
    m = p.measurement
    return m.feasible and not m.timed_out


def pareto_frontier(points: Iterable[ParetoPoint]) -> list[ParetoPoint]:
    """Non-dominated subset, sorted by ascending time (descending energy).

    Coordinate duplicates keep one representative (the first encountered at
    that (time, energy)); penalized measurements are excluded entirely.
    """
    candidates = [p for p in points if _runnable(p)]
    # Stable sort by (time, energy): a sweep keeping strictly-decreasing
    # energy then yields exactly the non-dominated set (ties and weakly
    # dominated points fall out because their energy is not an improvement).
    candidates.sort(key=lambda p: (p.time_s, p.energy_ws))
    frontier: list[ParetoPoint] = []
    best_energy = float("inf")
    for p in candidates:
        if p.energy_ws < best_energy:
            frontier.append(p)
            best_energy = p.energy_ws
    return frontier


def fleet_frontier(cell_frontiers: Iterable[Sequence[ParetoPoint]]
                   ) -> list[ParetoPoint]:
    """Fleet-wide frontier across cells (points keep their cell labels):
    which (cell, pattern) placements are globally non-dominated — the paper's
    mixed-destination comparison (arXiv:2011.12431) as a frontier."""
    merged: list[ParetoPoint] = []
    for f in cell_frontiers:
        merged.extend(f)
    return pareto_frontier(merged)


def frontier_by_cell(points: Iterable[ParetoPoint]
                     ) -> dict[str, list[ParetoPoint]]:
    """Group (fleet-)frontier points by their owning cell, preserving order.
    A cell absent from the result had every point dominated by another
    cell's placements — the signal the placement controller uses to drop a
    candidate destination before staged verification."""
    out: dict[str, list[ParetoPoint]] = {}
    for p in points:
        out.setdefault(p.cell, []).append(p)
    return out


def frontier_by_destination(
    points: Iterable[ParetoPoint],
    destination_of: Callable[[ParetoPoint], str],
) -> dict[str, list[ParetoPoint]]:
    """Group (fleet-)frontier points by offload destination, preserving
    order. ``destination_of`` maps a point to its destination label (the
    fleet router passes its cell→destination table; cell keys embed the mesh
    label but a destination is more than a mesh — a mixed environment runs
    the same mesh shape on different silicon)."""
    out: dict[str, list[ParetoPoint]] = {}
    for p in points:
        out.setdefault(destination_of(p), []).append(p)
    return out


def dominated_destinations(
    candidates: Sequence[str],
    frontier_points: Iterable[ParetoPoint],
    destination_of: Callable[[ParetoPoint], str],
) -> list[str]:
    """Candidate destinations contributing **no** point to the fleet
    frontier, in candidate order: every operating point they offer is
    dominated by some other destination's. This is the fleet router's
    drain signal — an engine pinned to a dominated destination should stop
    receiving traffic and its queued (not yet admitted) requests migrate
    to engines that still earn their place on the frontier."""
    on_frontier = {destination_of(p) for p in frontier_points}
    return [c for c in candidates if c not in on_frontier]


@dataclass(frozen=True)
class CapacityPoint:
    """One destination's operating economics for fleet provisioning: its
    marginal serving rate (Watt·s per token while busy), its static floor
    (watts burned per second merely for being awake) and the token
    throughput it can sustain. What energy-proportional autoscaling ranks
    and packs."""

    name: str
    energy_per_token_ws: float
    static_watts: float
    capacity_tps: float  # sustainable tokens per second
    order: int = 0  # catalog position: the deterministic tie-break


def amortized_ws_per_token(energy_per_token_ws: float, static_watts: float,
                           tokens_per_s: float) -> float:
    """True Watt·s cost of a token on a destination serving
    ``tokens_per_s``: the marginal rate plus the static floor amortized
    over the tokens it actually serves. At low utilization the static term
    dominates — the reason an idle destination is worth spinning down, and
    the quantity a fleet's Watt·s/1k-token bill actually integrates."""
    if tokens_per_s <= 0.0:
        return float("inf")
    return energy_per_token_ws + static_watts / tokens_per_s


def provision_awake_set(candidates: Sequence[CapacityPoint],
                        demand_tps: float, *, min_awake: int = 1,
                        headroom: float = 1.0) -> list[str]:
    """Energy-proportional provisioning: which destinations should be awake
    to serve ``demand_tps`` tokens/s.

    Candidates are ranked by their amortized Watt·s/token at their own full
    capacity (a destination that cannot amortize its static floor over many
    tokens ranks late) and greedily admitted until the awake set's combined
    capacity covers ``demand_tps x headroom``, with at least ``min_awake``
    members so the fleet never goes dark. Ties break on catalog order, so
    the awake set is deterministic for a given demand — the property the
    autoscaling regression pins."""
    need = max(demand_tps, 0.0) * max(headroom, 0.0)
    ranked = sorted(
        candidates,
        key=lambda c: (amortized_ws_per_token(
            c.energy_per_token_ws, c.static_watts, c.capacity_tps),
            c.order, c.name))
    awake: list[str] = []
    cap = 0.0
    for c in ranked:
        if len(awake) >= max(min_awake, 0) and cap >= need:
            break
        awake.append(c.name)
        cap += max(c.capacity_tps, 0.0)
    return awake


def allocate_demand(candidates: Sequence[CapacityPoint], demand_tps: float
                    ) -> dict[str, float]:
    """Greedy demand split across an awake set: fill destinations in
    ascending amortized Watt·s/token at their own capacity (same ranking as
    :func:`provision_awake_set`, same catalog-order tie-break), each up to
    its sustainable throughput, until ``demand_tps`` is placed. Unplaced
    demand (the fleet is under-provisioned) is silently dropped — callers
    compare ``sum(result.values())`` against the demand to detect it. The
    marginal-energy integral of this split is what a provisioning search
    bills a candidate fleet for serving its forecast mean rate."""
    remaining = max(demand_tps, 0.0)
    ranked = sorted(
        candidates,
        key=lambda c: (amortized_ws_per_token(
            c.energy_per_token_ws, c.static_watts, c.capacity_tps),
            c.order, c.name))
    alloc: dict[str, float] = {}
    for c in ranked:
        take = min(remaining, max(c.capacity_tps, 0.0))
        alloc[c.name] = take
        remaining -= take
        if remaining <= 0.0:
            break
    return alloc


def narrow(points: Iterable[ParetoPoint], req: Optional[UserRequirement]
           ) -> list[ParetoPoint]:
    """§3.3 narrowing: keep the points satisfying the user requirement."""
    if req is None:
        return list(points)
    return [p for p in points if req.satisfied(p.measurement)]


def select_operating_point(
    points: Iterable[ParetoPoint],
    req: Optional[UserRequirement] = None,
    prefer: str = "energy",
) -> Optional[ParetoPoint]:
    """Pick one frontier point: the requirement filters, ``prefer`` decides
    among survivors ("energy" | "time" | "fitness"). None when nothing
    runnable satisfies the requirement — the caller's cue to relax it or
    fall back to the CPU baseline, as the paper's staged flow does."""
    surviving = narrow(pareto_frontier(points), req)
    if not surviving:
        return None
    if prefer == "time":
        return min(surviving, key=lambda p: (p.time_s, p.energy_ws))
    if prefer == "fitness":
        return max(surviving, key=lambda p: p.fitness)
    return min(surviving, key=lambda p: (p.energy_ws, p.time_s))
