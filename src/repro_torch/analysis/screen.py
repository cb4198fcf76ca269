"""Static pre-screen: drop statically-dead fleet cells before measurement.

The paper narrows offload candidates by *static* loop analysis before the
GA ever measures them (its FPGA follow-up, arXiv 2004.08548, does the same
with arithmetic-intensity filters) — because the verification environment
itself burns power per measurement. This module is that stage for the
fleet sweep: before ``search_fleet`` measures a cell, the screen
enumerates the cell's **entire genome space through the same analytic
model the measurements use** (spaces are tiny — ≤ a few hundred genomes —
and ``analyze_cell`` is µs-cheap) and drops cells that provably cannot
matter:

* ``infeasible`` — no genome fits in HBM: every measurement would come
  back ``feasible=False``, and ``pareto_frontier`` excludes those, so the
  cell can never contribute a frontier point.
* ``dominated`` — some kept cell's *baseline* point (the zero genome,
  which every search measures unconditionally) Pareto-dominates **every**
  feasible point this cell can produce, with strict improvement against
  the cell's per-axis lower bounds. Exact-tie candidates are never
  dropped (the frontier keeps tie representatives by input order).
* ``intensity-floor`` — the dominated rule fired *and* the workload's
  arithmetic intensity sits below ``floor_frac`` of the silicon's ridge
  point (FLOPs/byte where compute = memory time): the roofline
  classification says the destination can't be energy-effective here, so
  the reason names the real cause rather than just "dominated".

Because the dominance proof quantifies over the cell's whole genome space
and compares against a point the unscreened run *always measures*, the
screened fleet's frontier, operating points, and every survivor's GA
winner are bit-identical to the unscreened run. Cells with a custom
measurement backend are never screened (the analytic model can't speak
for them).

Counterpart of the JAX package's ``analysis/screen.py``, copied as it is:
the screen is pure Python over the analytic cost model.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.fitness import Measurement
from repro_torch.core.lm_cost_model import cell_invariants, measure_cell
from repro_torch.core.pareto import dominates
from repro_torch.core.power import TPU_V5E, HardwareSpec, TpuPowerModel


@dataclasses.dataclass(frozen=True)
class ScreenPolicy:
    """Knobs for the static pre-screen.

    ``margin`` scales the kept baseline before the dominance test (>1.0 =
    more conservative, keeps more cells). ``max_enumeration`` caps the
    per-cell genome-space walk; larger spaces are kept unexamined.
    """

    infeasible: bool = True
    dominance: bool = True
    floor_frac: float = 0.05  # of the hw ridge intensity, for labeling
    margin: float = 1.0
    max_enumeration: int = 4096
    hw: HardwareSpec = TPU_V5E


@dataclasses.dataclass
class CellStatics:
    """Exact static profile of one cell (full genome-space enumeration)."""

    key: str
    group: Tuple[str, str]  # (arch, shape.name) — same-workload cells
    space_size: int
    feasible_count: int
    baseline: Measurement  # zero genome — always measured by any search
    min_time_s: float  # per-axis lower bounds over feasible points
    min_energy_ws: float
    intensity: float  # workload FLOPs / HBM byte (config-derived)
    classification: str  # "memory-bound" | "compute-bound"

    @property
    def all_infeasible(self) -> bool:
        return self.feasible_count == 0


@dataclasses.dataclass
class DroppedCell:
    key: str
    reason: str  # "infeasible" | "dominated" | "intensity-floor"
    detail: str


@dataclasses.dataclass
class ScreenReport:
    """What the screen kept, what it dropped, and why."""

    kept: list  # list[CellSpec] — preserved input order
    dropped: List[DroppedCell]
    statics: Dict[str, CellStatics]

    @property
    def cells_in(self) -> int:
        return len(self.kept) + len(self.dropped)

    def to_json(self) -> dict:
        return {
            "cells_in": self.cells_in,
            "cells_kept": len(self.kept),
            "dropped": [dataclasses.asdict(d) for d in self.dropped],
            "classification": {k: s.classification
                               for k, s in self.statics.items()},
        }


def cell_statics(spec, power: TpuPowerModel,
                 policy: ScreenPolicy) -> Optional[CellStatics]:
    """Enumerate the cell's genome space through the analytic model.

    Returns None when the cell can't be statically profiled (custom
    backend, or a genome space larger than ``policy.max_enumeration``).
    """
    from repro_torch.configs import get_config
    from repro_torch.core.offload_search import decisions_from, lm_genome_space

    if spec.backend:
        return None
    cfg = get_config(spec.arch)
    space = lm_genome_space(cfg, spec.shape)
    if space.size > policy.max_enumeration:
        return None
    cell_power = spec.power if spec.power is not None else power

    baseline: Optional[Measurement] = None
    feasible = 0
    min_t = min_e = float("inf")
    for genome in itertools.product(
            *(range(len(g.choices)) for g in space.genes)):
        dec = decisions_from(space, genome)
        m = measure_cell(cfg, spec.shape, spec.mesh_shape, dec,
                         power=cell_power)
        if genome == space.zeros():
            baseline = m
        if m.feasible and not m.timed_out:
            feasible += 1
            min_t = min(min_t, m.time_s)
            min_e = min(min_e, m.energy_ws)

    inv = cell_invariants(cfg, spec.shape)
    intensity = inv.fwd_flops / inv.unit_bytes if inv.unit_bytes else 0.0
    ridge = policy.hw.peak_flops / policy.hw.hbm_bw
    assert baseline is not None
    return CellStatics(
        key=spec.key, group=(spec.arch, spec.shape.name),
        space_size=space.size, feasible_count=feasible, baseline=baseline,
        min_time_s=min_t, min_energy_ws=min_e, intensity=intensity,
        classification="memory-bound" if intensity < ridge
        else "compute-bound")


def _strictly_covers(keeper: CellStatics, cand: CellStatics,
                     margin: float) -> bool:
    """True iff keeper's baseline dominates *every* point cand can produce.

    Componentwise against cand's per-axis lower bounds: base ≤ both bounds
    with strict improvement in one implies Pareto dominance over each
    individual feasible point, and exact ties are never covered (ties stay
    on the frontier as input-order representatives, so dropping one would
    change the frontier).
    """
    if not keeper.baseline.feasible or keeper.baseline.timed_out:
        return False
    bt = keeper.baseline.time_s * margin
    be = keeper.baseline.energy_ws * margin
    bound = Measurement(time_s=cand.min_time_s, energy_ws=cand.min_energy_ws)
    return dominates(Measurement(time_s=bt, energy_ws=be), bound)


def screen_cells(cells: Sequence, *,
                 policy: Optional[ScreenPolicy] = None,
                 power: TpuPowerModel = TpuPowerModel()) -> ScreenReport:
    """Partition ``cells`` into kept + dropped with exact static proofs."""
    policy = policy or ScreenPolicy()
    statics: Dict[str, CellStatics] = {}
    profiles = []
    for spec in cells:
        st = cell_statics(spec, power, policy)
        if st is not None:
            statics[st.key] = st
        profiles.append((spec, st))

    kept: list = []
    kept_statics: List[CellStatics] = []
    dropped: List[DroppedCell] = []
    ridge = policy.hw.peak_flops / policy.hw.hbm_bw
    for spec, st in profiles:
        if st is None:  # backend-opaque or too-large space: always measure
            kept.append(spec)
            continue
        if policy.infeasible and st.all_infeasible:
            dropped.append(DroppedCell(
                st.key, "infeasible",
                "no genome fits: %d/%d feasible (baseline %.1fs/%.0fWs "
                "discarded by the frontier anyway)"
                % (st.feasible_count, st.space_size, st.baseline.time_s,
                   st.baseline.energy_ws)))
            continue
        keeper = None
        if policy.dominance:
            keeper = next(
                (k for k in kept_statics
                 if k.group == st.group
                 and _strictly_covers(k, st, policy.margin)), None)
        if keeper is not None:
            if st.intensity < policy.floor_frac * ridge:
                dropped.append(DroppedCell(
                    st.key, "intensity-floor",
                    "%s workload at %.2f FLOPs/B is below %.2f (%.0f%% of "
                    "ridge %.0f); every point dominated by %s baseline"
                    % (st.classification, st.intensity,
                       policy.floor_frac * ridge, policy.floor_frac * 100,
                       ridge, keeper.key)))
            else:
                dropped.append(DroppedCell(
                    st.key, "dominated",
                    "%s: baseline of %s dominates all %d feasible points "
                    "(bounds t≥%.3gs e≥%.3gWs)"
                    % (st.classification, keeper.key, st.feasible_count,
                       st.min_time_s, st.min_energy_ws)))
            continue
        kept.append(spec)
        kept_statics.append(st)
    return ScreenReport(kept=kept, dropped=dropped, statics=statics)
