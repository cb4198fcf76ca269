"""Provisioning budgets: what an operator may build, before any request.

lumos (SNIPPETS.md 1-3) frames heterogeneous design as allocating one
total power/area budget across core types and accelerators; this module is
that constraint surface for the destination catalog. A :class:`Budget`
bounds the **nameplate** cost of standing destinations up:

* ``watts`` — total provisioned watts, debited at each destination's
  ``peak_watts`` (every component at full utilization). Power delivery is
  built for the worst case, not the average — a slice that idles cheap
  still needs its peak wired, which is exactly why over-building shows up
  twice: once here, and again as idle Watt·s on the serving bill.
* ``area`` — optional total chip area (``DestinationSpec.area`` units,
  defaulting to chips); None = unconstrained.
* ``count_caps`` — optional per-destination-type count ceilings (supply
  limits, rack space, a type the operator refuses to buy more of).

Budgets are frozen and validated on construction; :meth:`admits` is the
single feasibility predicate the multiset search calls.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional


@dataclass(frozen=True)
class Budget:
    """The build envelope a provisioning search must stay inside."""

    watts: float
    area: Optional[float] = None
    count_caps: tuple[tuple[str, int], ...] = ()

    def __post_init__(self) -> None:
        if self.watts <= 0.0:
            raise ValueError(f"Budget.watts = {self.watts} must be positive")
        if self.area is not None and self.area <= 0.0:
            raise ValueError(f"Budget.area = {self.area} must be positive "
                             "(or None for unconstrained)")
        for name, cap in self.count_caps:
            if cap < 0:
                raise ValueError(f"Budget count cap for {name!r} is {cap}; "
                                 "caps must be >= 0")
        names = [n for n, _ in self.count_caps]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate count caps in {names}")

    @staticmethod
    def create(watts: float, *, area: Optional[float] = None,
               count_caps: Optional[Mapping[str, int]] = None) -> "Budget":
        """Dict-friendly constructor (count caps sorted for a canonical,
        hashable representation)."""
        caps = tuple(sorted((count_caps or {}).items()))
        return Budget(watts=watts, area=area, count_caps=caps)

    def cap(self, name: str, default: int) -> int:
        """Count ceiling for one destination type (``default`` when the
        budget does not name it)."""
        for n, c in self.count_caps:
            if n == name:
                return c
        return default

    def admits(self, watts: float, area: float) -> bool:
        """Whether a fleet with this nameplate draw and die area fits."""
        if watts > self.watts:
            return False
        if self.area is not None and area > self.area:
            return False
        return True
