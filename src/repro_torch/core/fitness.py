"""The paper's fitness algebra (§3.1, §4.1.2).

    fitness = (processing_time)^(-1/2) × (power_usage)^(-1/2)

The -1/2 exponents flatten the landscape so one fast individual does not
collapse GA diversity (paper §4.1.2). Measurements that exceed the wall
budget are assigned the paper's 10 000 s timeout penalty. ``power_usage`` in
the paper's formula is the energy-like product actually measured in the
verification environment; we score Watt·seconds (energy), matching the
quantity the paper's Fig.5 evaluates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

TIMEOUT_SECONDS = 10_000.0  # paper: runs not finishing in 3 min score as 10^4 s


@dataclass(frozen=True)
class Measurement:
    """One verification-environment measurement of a pattern."""

    time_s: float
    energy_ws: float  # Watt·seconds
    timed_out: bool = False
    feasible: bool = True  # False: compile failure / resource overflow
    avg_watts: Optional[float] = None
    detail: Optional[dict] = None

    def effective_time(self) -> float:
        if self.timed_out or not self.feasible:
            return TIMEOUT_SECONDS
        return max(self.time_s, 1e-12)

    def effective_energy(self) -> float:
        if self.timed_out or not self.feasible:
            # paper scores timeouts through the time term; keep the energy
            # term equally pessimistic (idle watts for the penalty window)
            return TIMEOUT_SECONDS * (self.avg_watts or 27.0)
        return max(self.energy_ws, 1e-12)


def fitness(m: Measurement, *, time_exp: float = -0.5, energy_exp: float = -0.5
            ) -> float:
    """The paper's evaluation formula; exponents overridable per operator
    (§3.3 — cost structures differ between operators)."""
    return (m.effective_time() ** time_exp) * (m.effective_energy() ** energy_exp)


@dataclass(frozen=True)
class UserRequirement:
    """§3.3 early-exit criterion for staged mixed-environment verification."""

    max_time_s: Optional[float] = None
    max_energy_ws: Optional[float] = None
    min_speedup: Optional[float] = None  # vs CPU-only baseline
    baseline_time_s: Optional[float] = None

    def satisfied(self, m: Measurement) -> bool:
        if m.timed_out or not m.feasible:
            return False
        if self.max_time_s is not None and m.time_s > self.max_time_s:
            return False
        if self.max_energy_ws is not None and m.energy_ws > self.max_energy_ws:
            return False
        if self.min_speedup is not None:
            if self.baseline_time_s is None:
                return False
            if self.baseline_time_s / max(m.time_s, 1e-12) < self.min_speedup:
                return False
        return True


def watt_seconds(avg_watts: float, seconds: float) -> float:
    return avg_watts * seconds
