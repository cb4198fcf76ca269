"""Budgeted fleet provisioning: search which destinations to *build*.

Every layer below this one takes the hardware mix as given: the router
picks which existing engine serves a request, autoscaling picks which
existing engine stays awake. The operator question upstream of both —
the one lumos (SNIPPETS.md 1-3) poses for MPSoCs and ROADMAP item 2 poses
for this fleet — is which destinations to stand up at all, under a power
(and optionally chip-area) budget, before any request arrives. This module
answers it by reusing the existing machinery at one level up:

1. **economics** (:func:`destination_economics`) — one shared
   ``search_fleet`` sweep prices every (kind x destination) cell through
   the per-cell GA and its Pareto frontier, exactly as the router's
   control loop does, through the same (disk-persistable)
   ``PersistentEvalCache`` — so planning tomorrow's build reuses today's
   measurements and a cached re-plan performs **zero** new ones. The
   ``screen.py`` pre-screen drops infeasible cells before measurement
   (dominance pruning stays OFF: a cell dominated on the (time, energy)
   plane can still be the cheapest *per provisioned watt*, which is the
   axis this search optimizes).
2. **evaluation** (:func:`evaluate_fleet`) — a candidate build is a
   :class:`FleetGenome` (multiset of destination counts). Its nameplate
   watts/area debit the :class:`~repro_torch.provision.budget.Budget`; its
   serving cost at the forecast mean rate comes from the fleet's power-state
   model (``CapacityPoint`` / ``provision_awake_set`` /
   ``allocate_demand``), so the idle floors of over-provisioned engines
   — awake static draw for the provisioned set, sleep-fraction draw for
   the rest — count against the bill, not just marginal Watt·s/token.
3. **search** (:func:`plan_fleet`) — exact enumeration of the count
   lattice when it is small, deterministic greedy beam search over
   +1-instance expansions otherwise, maximizing served tokens/s subject
   to budget and per-tenant SLO feasibility, tie-breaking on the full
   Watt·s/1k bill then catalog order.
4. **frontier** (:func:`cost_of_capacity_frontier`) — the plan re-run
   across ascending watt budgets yields the cost-of-capacity curve
   (served tokens/s vs provisioned watts, with the chosen mix per point).
   Feasible sets nest as budgets grow, so the
   curve is monotone non-decreasing in served tokens/s — enforced by
   carrying a better smaller-budget build forward, and pinned by the
   property tests.

Everything downstream of the (deterministic) sweep is pure arithmetic over
frozen dataclasses: the same forecast + catalog + budget always returns
the identical plan, byte for byte.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.configs.destinations import DestinationSpec
from repro_torch.core.cache_store import PersistentEvalCache
from repro_torch.core.evaluator import EvalEngine, VectorizedExecutor
from repro_torch.core.fitness import UserRequirement
from repro_torch.core.ga import GAConfig
from repro_torch.core.offload_search import CellSpec, FleetResult, search_fleet
from repro_torch.core.pareto import (
    CapacityPoint, allocate_demand, provision_awake_set,
    select_operating_point,
)
from repro_torch.provision.budget import Budget
from repro_torch.workload.forecast import WorkloadForecast

# The serving kinds a build is priced on (import indirection avoided: the
# runtime placement catalog uses the same two production shapes).
PROVISION_KINDS = ("prefill", "decode")


# ---------------------------------------------------------------------------
# Destination economics (one shared sweep, GA + Pareto operating points)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KindRate:
    """One kind's chosen operating point on one destination, per token."""

    kind: str
    energy_per_token_ws: float
    time_per_token_s: float


@dataclass(frozen=True)
class DestinationEconomics:
    """Everything the multiset search needs to price one destination type."""

    spec: DestinationSpec
    order: int  # catalog position: the deterministic tie-break
    slots: int
    rates: tuple[KindRate, ...]

    @property
    def name(self) -> str:
        return self.spec.name

    def rate(self, kind: str) -> KindRate:
        for r in self.rates:
            if r.kind == kind:
                return r
        raise KeyError(f"{self.name} has no {kind!r} operating point")

    @property
    def capacity_tps(self) -> float:
        """Sustainable token throughput of ONE instance: slots over the
        slowest per-token step time (mirrors the router's
        ``engine_capacity_tps`` — a full engine emits one token per slot
        per step)."""
        worst = max(r.time_per_token_s for r in self.rates)
        return self.slots / worst if worst > 0.0 else 0.0

    def mix_energy_per_token_ws(self, prefill_frac: float) -> float:
        """Marginal Watt·s/token under the forecast prefill/decode mix."""
        return (prefill_frac * self.rate("prefill").energy_per_token_ws
                + (1.0 - prefill_frac)
                * self.rate("decode").energy_per_token_ws)

    def request_latency_s(self, prompt_tokens: int, new_tokens: int) -> float:
        """Modeled completion latency of one request on an unloaded
        instance (same accounting as the router's marginal estimate: the
        step consuming the last prompt token already emits the first
        output token)."""
        return (prompt_tokens * self.rate("prefill").time_per_token_s
                + max(new_tokens - 1, 0)
                * self.rate("decode").time_per_token_s)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "chips": self.spec.chips,
            "area": self.spec.area,
            "idle_watts": self.spec.idle_watts,
            "peak_watts": self.spec.peak_watts,
            "capacity_tps": self.capacity_tps,
            "rates": {r.kind: {"energy_per_token_ws": r.energy_per_token_ws,
                               "time_per_token_s": r.time_per_token_s}
                      for r in self.rates},
        }


@dataclass
class EconomicsResult:
    """The priced catalog plus the sweep it came from."""

    economics: list[DestinationEconomics]
    fleet: FleetResult
    skipped: dict[str, str]  # destination -> why it cannot be built

    @property
    def new_measurements(self) -> int:
        """Distinct measurements this sweep actually performed (0 on a
        cached re-plan — the determinism contract)."""
        return self.fleet.evaluations

    def by_name(self) -> dict[str, DestinationEconomics]:
        return {e.name: e for e in self.economics}


def destination_economics(
    arch: str,
    destinations: Sequence[DestinationSpec],
    *,
    shapes: dict,
    slots: int = 2,
    engine: Optional[EvalEngine] = None,
    cache_path: Optional[str] = None,
    ga_config: Optional[GAConfig] = None,
    requirement: Optional[UserRequirement] = None,
    cell_workers: int = 1,
    screen: bool = True,
) -> EconomicsResult:
    """Price every destination type with one shared ``search_fleet`` sweep.

    ``shapes`` maps each provisioning kind ("prefill"/"decode") to the
    production :class:`ShapeSpec` it is priced on (the router's
    ``DEFAULT_CATALOG`` is the usual argument). Cells carry each
    destination's own power model (the ``@pw:`` namespace keeps results
    apart); the per-cell energy-minimal frontier point — narrowed by
    ``requirement`` when given — becomes the destination's per-token rate.
    A destination whose cell was screened infeasible, or whose frontier
    has no point satisfying the requirement, is excluded from the build
    catalog and recorded in ``skipped``.
    """
    from repro_torch.analysis.screen import ScreenPolicy

    eng = engine
    if eng is None:
        if cache_path:
            eng = EvalEngine(executor=VectorizedExecutor(),
                             cache=PersistentEvalCache(cache_path))
        else:
            eng = EvalEngine(executor=VectorizedExecutor())
    cells: dict[tuple[str, str], CellSpec] = {}
    for kind in PROVISION_KINDS:
        shape = shapes[kind]
        for d in destinations:
            cells[(kind, d.name)] = CellSpec.create(
                arch, shape, d.mesh_shape, power=d.power)
    # dominance pruning OFF: (time, energy)-dominated cells can still win
    # per provisioned watt; only provably infeasible cells are dropped
    policy = ScreenPolicy(dominance=False) if screen else None
    fleet = search_fleet(list(cells.values()), ga_config=ga_config,
                         engine=eng, cell_workers=cell_workers,
                         screen=policy)
    by_cell = fleet.by_cell()

    economics: list[DestinationEconomics] = []
    skipped: dict[str, str] = {}
    for order, d in enumerate(destinations):
        rates: list[KindRate] = []
        why = None
        for kind in PROVISION_KINDS:
            spec = cells[(kind, d.name)]
            cr = by_cell.get(spec.key)
            if cr is None:
                why = f"{kind} cell screened infeasible"
                break
            pt = select_operating_point(cr.search.frontier, requirement,
                                        prefer="energy")
            if pt is None:
                why = f"no {kind} operating point satisfies the requirement"
                break
            tokens = max(cr.spec.shape.tokens(), 1)
            rates.append(KindRate(kind=kind,
                                  energy_per_token_ws=pt.energy_ws / tokens,
                                  time_per_token_s=pt.time_s / tokens))
        if why is not None:
            skipped[d.name] = why
            continue
        economics.append(DestinationEconomics(
            spec=d, order=order, slots=slots, rates=tuple(rates)))
    return EconomicsResult(economics=economics, fleet=fleet, skipped=skipped)


# ---------------------------------------------------------------------------
# Fleet genomes (multisets of destination counts) and their evaluation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FleetGenome:
    """One candidate build: how many instances of each destination type.

    ``counts`` is canonical — catalog order, zero counts omitted — so equal
    builds compare and hash equal and the search's visited-set works."""

    counts: tuple[tuple[str, int], ...]

    @staticmethod
    def create(counts: dict, order: Sequence[str]) -> "FleetGenome":
        missing = set(counts) - set(order)
        if missing:
            raise ValueError(f"unknown destination types {sorted(missing)}")
        return FleetGenome(tuple((n, int(counts[n])) for n in order
                                 if counts.get(n, 0) > 0))

    def count(self, name: str) -> int:
        for n, c in self.counts:
            if n == name:
                return c
        return 0

    @property
    def total(self) -> int:
        return sum(c for _, c in self.counts)

    @property
    def label(self) -> str:
        if not self.counts:
            return "(nothing)"
        return "+".join(f"{c}x{n}" for n, c in self.counts)

    def as_dict(self) -> dict[str, int]:
        return dict(self.counts)


@dataclass(frozen=True)
class FleetEvaluation:
    """One candidate build, scored against a budget and a forecast."""

    genome: FleetGenome
    provisioned_watts: float  # nameplate: what must be built
    provisioned_area: float
    capacity_tps: float  # combined sustainable throughput
    served_tps: float  # min(forecast peak, capacity) — the objective
    mean_served_tps: float  # min(forecast mean, capacity) — the bill's rate
    power_w: float  # average draw serving the mean rate (full bill)
    ws_per_1k: float  # power_w / mean_served_tps * 1000
    slo_ok: bool
    within_budget: bool
    awake: tuple[str, ...]  # instances the mean rate keeps provisioned

    @property
    def feasible(self) -> bool:
        return self.within_budget and self.slo_ok and self.genome.total > 0

    def sort_key(self) -> tuple:
        """Deterministic preference: SLO-holding first, most served
        tokens/s, cheapest full bill, least nameplate watts, then the
        canonical counts tuple so exact ties are stable."""
        return (not self.slo_ok, -self.served_tps, self.ws_per_1k,
                self.provisioned_watts, self.genome.counts)

    def to_json(self) -> dict:
        return {
            "mix": self.genome.as_dict(),
            "label": self.genome.label,
            "provisioned_watts": self.provisioned_watts,
            "provisioned_area": self.provisioned_area,
            "capacity_tps": self.capacity_tps,
            "served_tps": self.served_tps,
            "mean_served_tps": self.mean_served_tps,
            "power_w": self.power_w,
            "ws_per_1k": self.ws_per_1k,
            "slo_ok": self.slo_ok,
            "within_budget": self.within_budget,
            "awake": list(self.awake),
        }


def evaluate_fleet(
    genome: FleetGenome,
    economics: Sequence[DestinationEconomics],
    budget: Budget,
    forecast: WorkloadForecast,
    *,
    min_awake: int = 1,
    headroom: float = 1.0,
) -> FleetEvaluation:
    """Score one candidate build.

    Nameplate watts/area debit the budget. The serving bill at the
    forecast mean rate reuses the fleet's power-state economics: per-instance
    :class:`CapacityPoint`s are provisioned with
    :func:`~repro_torch.core.pareto.provision_awake_set` (amortized
    Watt·s/token ranking), demand is split by
    :func:`~repro_torch.core.pareto.allocate_demand`, provisioned instances
    bill their full idle floor, and the rest bill their deep-sleep
    fraction — an over-built fleet pays for every instance it stood up,
    which is the whole point of budgeted provisioning. SLO feasibility
    asks, per SLO'd tenant, for at least one built type whose modeled
    median-request latency fits the tenant's completion SLO.
    """
    by_name = {e.name: e for e in economics}
    watts = area = capacity = 0.0
    points: list[CapacityPoint] = []
    idle_by_instance: dict[str, float] = {}
    mix_e: dict[str, float] = {}
    for name, count in genome.counts:
        e = by_name[name]
        watts += count * e.spec.peak_watts
        area += count * e.spec.area
        capacity += count * e.capacity_tps
        mix_e[name] = e.mix_energy_per_token_ws(forecast.prefill_frac)
        for i in range(count):
            iname = f"{name}:{i}"
            points.append(CapacityPoint(
                name=iname, energy_per_token_ws=mix_e[name],
                static_watts=e.spec.idle_watts,
                capacity_tps=e.capacity_tps,
                order=e.order * 4096 + i))
            idle_by_instance[iname] = e.spec.idle_watts

    mean_served = min(forecast.mean_tps, capacity)
    served = min(forecast.peak_tps, capacity)

    awake: tuple[str, ...] = ()
    power_w = 0.0
    if points:
        awake = tuple(provision_awake_set(
            points, forecast.mean_tps,
            min_awake=min(max(min_awake, 1), len(points)),
            headroom=headroom))
        awake_set = set(awake)
        awake_points = [p for p in points if p.name in awake_set]
        alloc = allocate_demand(awake_points, mean_served)
        for p in awake_points:
            power_w += alloc.get(p.name, 0.0) * p.energy_per_token_ws
            power_w += p.static_watts
        sleep_fracs = {e.name: e.spec.sleep_frac for e in economics}
        for iname, idle in idle_by_instance.items():
            if iname not in awake_set:
                power_w += sleep_fracs[iname.rsplit(":", 1)[0]] * idle

    slo_ok = True
    for tenant in forecast.slo_tenants():
        fits = any(
            by_name[name].request_latency_s(
                tenant.prompt_median, tenant.new_tokens_median)
            <= tenant.slo_s
            for name, _ in genome.counts)
        if not fits:
            slo_ok = False
            break

    return FleetEvaluation(
        genome=genome,
        provisioned_watts=watts,
        provisioned_area=area,
        capacity_tps=capacity,
        served_tps=served,
        mean_served_tps=mean_served,
        power_w=power_w,
        ws_per_1k=(power_w / mean_served * 1000.0
                   if mean_served > 0.0 else float("inf")),
        slo_ok=slo_ok,
        within_budget=budget.admits(watts, area),
        awake=awake)


# ---------------------------------------------------------------------------
# Multiset search (exact enumeration or deterministic beam)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SearchPolicy:
    """Knobs for the count-lattice search.

    ``max_enumeration`` bounds the exact walk of the count lattice
    (product of per-type cap+1); larger spaces fall back to the greedy
    beam over +1-instance expansions. Both are fully deterministic."""

    max_enumeration: int = 20_000
    beam_width: int = 8
    max_count_per_type: int = 64
    min_awake: int = 1
    headroom: float = 1.0


@dataclass
class ProvisionResult:
    """The recommendation plus how the search got there."""

    best: Optional[FleetEvaluation]  # None: nothing buildable under budget
    budget: Budget
    method: str  # "exact" | "beam"
    evaluated: int  # candidate builds scored
    caps: dict[str, int]  # per-type count ceiling the budget implied

    @property
    def counts(self) -> dict[str, int]:
        return self.best.genome.as_dict() if self.best else {}

    def destinations(self, catalog: dict[str, DestinationSpec]
                     ) -> list[DestinationSpec]:
        """Expand the recommended multiset into the (repeating) destination
        list a :class:`~repro_torch.runtime.router.FleetRouter` takes."""
        out: list[DestinationSpec] = []
        if self.best:
            for name, count in self.best.genome.counts:
                out.extend([catalog[name]] * count)
        return out

    def to_json(self) -> dict:
        return {
            "best": self.best.to_json() if self.best else None,
            "budget": {"watts": self.budget.watts, "area": self.budget.area,
                       "count_caps": dict(self.budget.count_caps)},
            "method": self.method,
            "evaluated": self.evaluated,
            "caps": dict(self.caps),
        }


def _type_caps(economics: Sequence[DestinationEconomics], budget: Budget,
               policy: SearchPolicy) -> dict[str, int]:
    """Per-type count ceilings the budget implies (0 = cannot build one)."""
    caps: dict[str, int] = {}
    for e in economics:
        cap = policy.max_count_per_type
        if e.spec.peak_watts > 0.0:
            cap = min(cap, int(budget.watts // e.spec.peak_watts))
        if budget.area is not None and e.spec.area > 0.0:
            cap = min(cap, int(budget.area // e.spec.area))
        caps[e.name] = max(min(cap, budget.cap(e.name, cap)), 0)
    return caps


def plan_fleet(
    economics: Sequence[DestinationEconomics],
    budget: Budget,
    forecast: WorkloadForecast,
    *,
    policy: SearchPolicy = SearchPolicy(),
) -> ProvisionResult:
    """Search the destination-count multiset space under ``budget``.

    Exact enumeration walks the whole count lattice when it is small
    enough; otherwise a greedy beam grows builds one instance at a time,
    keeping the ``beam_width`` best-scoring partial builds per level.
    Either way the best build maximizes served tokens/s among SLO-feasible
    within-budget candidates (SLO-infeasible builds rank strictly after
    every SLO-holding one), tie-breaking on the full Watt·s/1k bill, then
    nameplate watts, then the canonical counts tuple — fully
    deterministic. ``best=None`` means the budget cannot stand up even one
    instance of any type."""
    econ = list(economics)
    caps = _type_caps(econ, budget, policy)
    names = [e.name for e in econ]

    def score(genome: FleetGenome) -> FleetEvaluation:
        return evaluate_fleet(genome, econ, budget, forecast,
                              min_awake=policy.min_awake,
                              headroom=policy.headroom)

    best: Optional[FleetEvaluation] = None
    evaluated = 0

    def consider(ev: FleetEvaluation) -> None:
        nonlocal best
        if not ev.within_budget or ev.genome.total == 0:
            return
        if best is None or ev.sort_key() < best.sort_key():
            best = ev

    space = 1
    for n in names:
        space *= caps[n] + 1
    if space <= policy.max_enumeration:
        method = "exact"
        for combo in itertools.product(
                *(range(caps[n] + 1) for n in names)):
            genome = FleetGenome(tuple(
                (n, c) for n, c in zip(names, combo) if c > 0))
            if genome.total == 0:
                continue
            ev = score(genome)
            evaluated += 1
            consider(ev)
    else:
        method = "beam"
        beam: list[tuple[tuple, FleetGenome]] = [((), FleetGenome(()))]
        seen: set[tuple[tuple[str, int], ...]] = {()}
        while beam:
            level: list[tuple[tuple, FleetGenome]] = []
            for _, genome in beam:
                base = genome.as_dict()
                for n in names:
                    if base.get(n, 0) >= caps[n]:
                        continue
                    grown = dict(base)
                    grown[n] = grown.get(n, 0) + 1
                    g2 = FleetGenome.create(grown, names)
                    if g2.counts in seen:
                        continue
                    seen.add(g2.counts)
                    ev = score(g2)
                    evaluated += 1
                    if not ev.within_budget:
                        continue
                    consider(ev)
                    level.append((ev.sort_key(), g2))
            level.sort(key=lambda item: item[0])
            beam = level[:policy.beam_width]

    return ProvisionResult(best=best, budget=budget, method=method,
                           evaluated=evaluated, caps=caps)


# ---------------------------------------------------------------------------
# Cost-of-capacity frontier
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FrontierPoint:
    """One point on the cost-of-capacity curve: the best build at one
    watt-budget level."""

    budget_w: float
    provisioned_watts: float
    served_tps: float
    ws_per_1k: float
    slo_ok: bool
    mix: tuple[tuple[str, int], ...]

    def to_json(self) -> dict:
        return {
            "budget_w": self.budget_w,
            "provisioned_watts": self.provisioned_watts,
            "served_tps": self.served_tps,
            "ws_per_1k": self.ws_per_1k,
            "slo_ok": self.slo_ok,
            "mix": dict(self.mix),
        }


def cost_of_capacity_frontier(
    economics: Sequence[DestinationEconomics],
    budgets_w: Sequence[float],
    forecast: WorkloadForecast,
    *,
    area: Optional[float] = None,
    count_caps: Optional[dict] = None,
    policy: SearchPolicy = SearchPolicy(),
) -> list[FrontierPoint]:
    """Plan at each ascending watt budget; emit (tokens/s vs provisioned
    watts) with the chosen mix per point. Budget levels where nothing is
    buildable produce no point. Feasible sets nest as the budget grows, so
    served tokens/s is monotone non-decreasing along the curve; if a
    larger budget's (beam) search ever surfaces a worse build than a
    smaller budget already found, the smaller budget's build — still
    affordable — is carried forward instead."""
    points: list[FrontierPoint] = []
    prev: Optional[FleetEvaluation] = None
    for w in sorted(budgets_w):
        result = plan_fleet(economics, Budget.create(
            w, area=area, count_caps=count_caps), forecast, policy=policy)
        ev = result.best
        if ev is None and prev is None:
            continue
        if ev is None or (prev is not None
                          and ev.sort_key() > prev.sort_key()):
            ev = prev  # a smaller budget's build still fits this one
        prev = ev
        points.append(FrontierPoint(
            budget_w=float(w),
            provisioned_watts=ev.provisioned_watts,
            served_tps=ev.served_tps,
            ws_per_1k=ev.ws_per_1k,
            slo_ok=ev.slo_ok,
            mix=ev.genome.counts))
    return points
