"""Fleet router: energy-aware serving across mixed offload destinations.

The placement controller's loop (observe → sweep → narrow → reconfigure)
adapts one :class:`~repro_torch.runtime.serving.ServingEngine`. The paper's
end goal is a *mixed offloading destination environment* (arXiv:2011.12431: GPU
+ FPGA + many-core CPU side by side, with arXiv:2110.11520 measuring the Watt·s
consequences): many engines, each pinned to a different destination, with
live traffic routed to whichever destination serves each request cheapest.
:class:`FleetRouter` is that layer:

* **admission routing** — every submitted :class:`Request` is admitted to
  the engine whose current :class:`Placement` minimizes the request's
  *marginal modeled Watt·s* (prompt tokens at the engine's prefill rate +
  generated tokens at its decode rate), subject to the request's ``slo_s``
  (engines whose modeled queue wait + completion latency blow the SLO drop
  out of the candidate set). The policy is pluggable: ``"energy"`` (the
  paper's objective), ``"latency"`` (fastest modeled completion), and
  ``"round_robin"`` (the homogeneous-fleet baseline).
* **fleet ledger** — per-engine :class:`EngineStats` aggregate by plain
  field-wise summation into one fleet-wide ledger (Watt·s, occupancy,
  SLO-at-risk): the fleet ledger *is* the sum of the engine ledgers, and
  tests pin that invariant.
* **one shared sweep** — :meth:`plan` observes the *union* traffic mix
  across engines and runs a single ``search_fleet`` sweep over
  (kind × occupancy-bucket) cells × every fleet destination through the
  shared (disk-persisted) :class:`~repro_torch.core.evaluator.EvalEngine`
  cache, then narrows **per engine** on that engine's own destination
  cells — so N engines re-plan on one sweep's measurements and a repeat re-plan
  performs zero new measurements. Destinations differ in *silicon*, not
  just mesh size (:mod:`repro_torch.configs.destinations` pairs each mesh with
  its own power model), so the narrowing has real energy spreads to work
  with.
* **drain/rebalance** — a destination whose swept operating points are
  dominated on every kind's fleet frontier has no reason to receive
  traffic;
  :meth:`rebalance` migrates its *queued (never admitted)* requests to
  surviving engines through the normal routing policy. Admitted requests
  are never moved, so no token is ever billed twice.
* **energy-proportional autoscaling** — every engine carries sleep/wake +
  DVFS-floor power states whose static watts come from its destination's
  ``TpuPowerModel`` idle floor (``configs/destinations.py``), charged to
  the fleet ledger (``EngineStats.idle_ws``) for every second the engine
  is not stepping. :meth:`scale_to` (and :meth:`plan` with
  ``autoscale=True`` and a clock) packs the observed arrival rate into the
  cheapest awake set by amortized Watt·s/token
  (``core/pareto.py:provision_awake_set``), wakes what demand needs and
  spins the rest down; wake latency is charged against request SLOs in
  routing (``eta_s`` adds the wake penalty), and a sleeping engine never
  admits or bills a token. ``workload/`` replays seeded open-loop traces
  against it on a virtual clock.

Engines run their real decode loops independently; :meth:`run` drives them
sequentially, which keeps fleet outputs token-identical to running each
engine alone on its assigned requests (the ledger integrates *modeled*
time/energy, so serving order does not change any reported number).

Counterpart of the JAX package's ``runtime/router.py``, pure Python over the
port's :class:`ServingEngine`: every engine holds the one shared
``TransformerLM`` and serves on one ``device`` (None: the card), and the
routing, plans, power states and ledgers are bit-identical to the
reference's. The Watt·s they price are ``TpuPowerModel``'s (a TPU v5e model)
for each destination, not the card's draw.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from repro_torch.configs import ShapeSpec
from repro_torch.configs.destinations import DestinationSpec
from repro_torch.core.cache_store import PersistentEvalCache
from repro_torch.core.device_select import Destination, SelectionReport, \
    select_destination
from repro_torch.core.evaluator import EvalEngine, VectorizedExecutor
from repro_torch.core.fitness import Measurement, UserRequirement
from repro_torch.core.ga import GAConfig
from repro_torch.core.offload_search import CellSpec, FleetResult, search_fleet
from repro_torch.core.pareto import (
    CapacityPoint, ParetoPoint, fleet_frontier, provision_awake_set,
    select_operating_point,
)
from repro_torch.runtime.placement import DEFAULT_CATALOG, TrafficMix, \
    narrowing_requirement, occupancy_bucket, scale_shape, static_placements
from repro_torch.runtime.serving import EngineStats, Placement, Request, \
    ServingEngine

POLICIES = ("energy", "latency", "round_robin")

_INFEASIBLE = Measurement(time_s=0.0, energy_ws=0.0, feasible=False)


@dataclass
class EngineBinding:
    """One fleet member: a serving engine pinned to a catalog destination."""

    name: str
    dest: DestinationSpec
    engine: ServingEngine
    order: int  # catalog position: the deterministic tie-break


@dataclass
class RouterPlanReport:
    """Introspection record of one shared observe→sweep→narrow pass."""

    mix: TrafficMix
    fleet: Optional[FleetResult]
    # engine name -> kind -> adopted placement (only engines that changed)
    placements: dict[str, dict[str, Placement]] = field(default_factory=dict)
    # kind -> staged §3.3 preferred destination over the whole fleet
    preferred: dict[str, str] = field(default_factory=dict)
    selections: dict[str, SelectionReport] = field(default_factory=dict)
    # destinations dominated on EVERY swept kind's fleet frontier
    dominated: list[str] = field(default_factory=list)
    new_measurements: int = 0
    # autoscaling verdict of this pass (empty when autoscale off / no clock)
    power_states: dict[str, str] = field(default_factory=dict)
    demand_tps: Optional[float] = None


class FleetRouter:
    """Owns N serving engines on mixed destinations and routes live traffic.

    All engines share one model (``cfg``/``model`` — what actually decodes
    locally, on ``device``: None means the card) and one
    ``slots``/``max_len`` geometry; they differ in the
    *destination* their placements are priced on. ``destinations`` may
    repeat a spec (a homogeneous scale-out fleet): engines are then named
    ``"<dest>:<i>"`` while the shared sweep still plans the destination
    once.
    """

    def __init__(
        self,
        cfg,
        model,
        destinations: Sequence[DestinationSpec],
        *,
        arch: str,
        policy: str = "energy",
        slots: int = 4,
        max_len: int = 64,
        scheduler: str = "stream",
        overflow: str = "reject",
        cache_path: Optional[str] = "results/eval_cache.jsonl",
        cache_compact: bool = True,
        eval_engine: Optional[EvalEngine] = None,
        ga_config: Optional[GAConfig] = None,
        requirement: Optional[UserRequirement] = None,
        require_energy_improvement: bool = True,
        catalog: Optional[dict[str, ShapeSpec]] = None,
        min_kind_weight: float = 0.02,
        prefer: str = "energy",
        autoscale: bool = False,
        min_awake: int = 1,
        headroom: float = 1.25,
        sleep_after_s: float = 0.0,
        saturation_factor: float = 4.0,
        device=None,
    ) -> None:
        if not destinations:
            raise ValueError("need at least one destination")
        if policy not in POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}; "
                             f"one of {POLICIES}")
        self.arch = arch
        self.policy = policy
        self.catalog = dict(catalog or DEFAULT_CATALOG)
        self.requirement = requirement
        self.require_energy_improvement = require_energy_improvement
        self.min_kind_weight = min_kind_weight
        self.prefer = prefer
        self.autoscale = autoscale
        self.min_awake = max(int(min_awake), 1)
        self.headroom = headroom
        self.sleep_after_s = sleep_after_s
        self.saturation_factor = saturation_factor
        self.ga_config = ga_config or GAConfig(population=10, generations=8)
        if eval_engine is None:
            if cache_path:
                eval_engine = EvalEngine(
                    executor=VectorizedExecutor(),
                    cache=PersistentEvalCache(cache_path,
                                              compact=cache_compact))
            else:
                eval_engine = EvalEngine(executor=VectorizedExecutor())
        self.eval_engine = eval_engine

        counts: dict[str, int] = {}
        for d in destinations:
            counts[d.name] = counts.get(d.name, 0) + 1
        seen: dict[str, int] = {}
        self._bindings: list[EngineBinding] = []
        for i, d in enumerate(destinations):
            if counts[d.name] > 1:
                name = f"{d.name}:{seen.get(d.name, 0)}"
                seen[d.name] = seen.get(d.name, 0) + 1
            else:
                name = d.name
            engine = ServingEngine(cfg, model, slots=slots, max_len=max_len,
                                   overflow=overflow, scheduler=scheduler,
                                   name=name, device=device)
            engine.reconfigure(static_placements(
                arch, d.mesh_shape, catalog=self.catalog, power=d.power,
                destination=d.name))
            engine.set_power(idle_watts=d.idle_watts,
                             floor_frac=d.floor_frac,
                             sleep_frac=d.sleep_frac,
                             wake_s=d.wake_s,
                             floor_wake_s=d.floor_wake_s)
            self._bindings.append(EngineBinding(name, d, engine, i))
        # unique destinations in first-appearance order: what one shared
        # sweep plans over (a homogeneous fleet plans its destination once)
        self.destinations: list[DestinationSpec] = []
        for d in destinations:
            if all(x.name != d.name for x in self.destinations):
                self.destinations.append(d)

        self.assignments: dict[int, str] = {}  # rid -> engine name
        # every mid-flight move, in order: (rid, source name, target name)
        self.moves: list[tuple[int, str, str]] = []
        self.rejected: list[Request] = []
        self.history: list[RouterPlanReport] = []
        self._rr = 0
        self._last: dict[str, EngineStats] = {
            b.name: b.engine.stats.snapshot() for b in self._bindings}
        self._last_observe_t: Optional[float] = None
        self._idle_since: dict[str, float] = {}

    @classmethod
    def provisioned(
        cls,
        cfg,
        model,
        counts: dict[str, int],
        *,
        catalog: Optional[dict[str, DestinationSpec]] = None,
        **kwargs,
    ) -> "FleetRouter":
        """Build a router from a provisioning plan's destination multiset.

        ``counts`` maps destination-type names to instance counts — exactly
        what :class:`~repro_torch.provision.planner.ProvisionResult` recommends
        (``result.counts``). ``catalog`` resolves names to specs (default:
        the built-in destination catalog); remaining keyword arguments pass
        through to the constructor unchanged. Types appear in catalog
        order, so the engine naming (``"<dest>:<i>"``) is deterministic
        for a given plan.
        """
        from repro_torch.configs.destinations import DESTINATIONS
        table = dict(catalog or DESTINATIONS)
        unknown = set(counts) - set(table)
        if unknown:
            raise ValueError(
                f"provisioned counts name unknown destinations "
                f"{sorted(unknown)}; catalog has {sorted(table)}")
        destinations: list[DestinationSpec] = []
        for name, spec in table.items():
            destinations.extend([spec] * max(int(counts.get(name, 0)), 0))
        if not destinations:
            raise ValueError("provisioned counts expand to an empty fleet")
        return cls(cfg, model, destinations, **kwargs)

    # -- fleet surface -------------------------------------------------
    @property
    def bindings(self) -> list[EngineBinding]:
        return list(self._bindings)

    @property
    def engines(self) -> dict[str, ServingEngine]:
        return {b.name: b.engine for b in self._bindings}

    def fleet_stats(self) -> EngineStats:
        """The fleet-wide ledger: the field-wise sum of every engine's
        :class:`EngineStats` (derived metrics like ``occupancy`` then come
        out traffic-weighted for free)."""
        total = EngineStats()
        for b in self._bindings:
            for f in EngineStats.__dataclass_fields__:
                setattr(total, f, getattr(total, f)
                        + getattr(b.engine.stats, f))
        return total

    def per_engine_stats(self) -> dict[str, EngineStats]:
        return {b.name: b.engine.stats.snapshot() for b in self._bindings}

    # -- routing -------------------------------------------------------
    def marginal_energy_ws(self, engine: ServingEngine, req: Request
                           ) -> float:
        """Modeled Watt·s this request would add to ``engine``'s ledger
        under its current placements: prompt tokens at the prefill rate plus
        generated tokens at the decode rate (the step consuming the last
        prompt token bills as prefill and already emits the first output
        token, hence ``max_new_tokens - 1`` decode tokens)."""
        return (len(req.prompt) * engine.token_energy_ws("prefill")
                + max(req.max_new_tokens - 1, 0)
                * engine.token_energy_ws("decode"))

    def eta_s(self, binding: EngineBinding, req: Request,
              now: Optional[float] = None) -> float:
        """Modeled completion latency on this engine: queued backlog spread
        over its slots, plus the request's own placement-modeled latency.
        With a clock, a spun-down engine's remaining wake latency joins the
        estimate — waking a big pod can blow a tight SLO all by itself."""
        eng = binding.engine
        wait = sum(eng.modeled_latency_s(q) for q in eng.queue) \
            / max(eng.slots, 1)
        wake = eng.wake_penalty_s(now) if now is not None else 0.0
        return wake + wait + eng.modeled_latency_s(req)

    def _awake_pool(self, pool: Sequence[EngineBinding],
                    now: Optional[float]) -> Sequence[EngineBinding]:
        """Routing candidates under power states: asleep engines never admit.
        If the whole pool is dark, the cheapest-to-wake member is woken on
        the spot (the fleet never refuses traffic just because it scaled to
        zero); its wake latency then shows up in ``eta_s``."""
        if now is None:
            return pool
        for b in pool:
            b.engine.check_awake(now)
        awake = [b for b in pool if b.engine.power_state != "asleep"]
        if awake:
            return awake
        b = min(pool, key=lambda x: (x.dest.wake_s, x.order))
        b.engine.wake(now)
        self._idle_since.pop(b.name, None)
        return [b]

    def _route(self, req: Request, pool: Sequence[EngineBinding],
               now: Optional[float] = None) -> EngineBinding:
        if self.policy == "round_robin":
            b = pool[self._rr % len(pool)]
            self._rr += 1
            return b
        pool = self._awake_pool(pool, now)
        if req.slo_s is not None:
            feasible = [b for b in pool
                        if self.eta_s(b, req, now) <= req.slo_s]
            if feasible:
                pool = feasible
            else:
                # no engine can hold the SLO: least-late wins (the request
                # is then counted slo_at_risk at admission)
                return min(pool, key=lambda b: (self.eta_s(b, req, now),
                                                b.order))
        if self.policy == "latency":
            return min(pool, key=lambda b: (self.eta_s(b, req, now), b.order))
        return min(pool, key=lambda b: (self.marginal_energy_ws(b.engine, req),
                                        self.eta_s(b, req, now), b.order))

    def route(self, req: Request, now: Optional[float] = None) -> str:
        """The engine the current policy would admit ``req`` to (pure: no
        state changes except the round-robin cursor on actual submit)."""
        if self.policy == "round_robin":
            return self._bindings[self._rr % len(self._bindings)].name
        return self._route(req, self._bindings, now).name

    def submit(self, req: Request, now: Optional[float] = None) -> bool:
        """Route and submit; False when the chosen engine rejects (empty
        prompt, or the overflow policy refusing an oversized one). With a
        clock, power states participate: asleep engines are skipped (woken
        only if the whole fleet is dark) and a floor-state target is woken
        so the admission actually decodes."""
        binding = self._route(req, self._bindings, now)
        if now is not None and binding.engine.power_state != "awake":
            binding.engine.wake(now)
            self._idle_since.pop(binding.name, None)
        ok = binding.engine.submit(req)
        if ok:
            self.assignments[req.rid] = binding.name
        else:
            self.rejected.append(req)
        return ok

    def run(self, max_waves: int = 64,
            max_steps: Optional[int] = None, *,
            concurrent: bool = False,
            max_workers: Optional[int] = None,
            on_tick=None,
            rebalance_every: int = 0) -> list[Request]:
        """Drain every engine's queue; returns finished requests (engine
        order, completion order within an engine). Engines decode
        independently, so outputs are token-identical to running each engine
        alone on its assigned requests, and the modeled ledger is
        independent of serving order.

        ``concurrent=True`` steps the engines on a thread pool in lockstep
        ticks (:class:`~repro_torch.runtime.executor.FleetExecutor`) —
        token-identical and ledger-identical to the sequential drain (the
        per-engine step schedules are unchanged; only the cross-engine
        interleaving differs, which no engine can observe), pinned by
        regression test. The reference's ``dwell_s``, a sleep standing in
        for the device's wait, has no counterpart: here the wait is real.

        ``on_tick`` (concurrent only) runs on the coordinator thread after
        every tick barrier — the single moment no worker holds any engine,
        which is where mid-flight migrations are safe; ``rebalance_every=k``
        installs the canonical hook: every k ticks, escalate
        :meth:`rebalance` to live load-shedding off saturated engines."""
        if concurrent:
            from repro_torch.runtime.executor import FleetExecutor
            if rebalance_every > 0:
                user_tick = on_tick

                def on_tick(tick, _user=user_tick):  # noqa: F811
                    if tick % rebalance_every == 0:
                        self.rebalance(live=True, include_saturated=True)
                    if _user is not None:
                        _user(tick)
            ex = FleetExecutor(self._bindings, max_workers=max_workers,
                               on_tick=on_tick)
            return ex.run(max_waves=max_waves, max_steps=max_steps)
        done: list[Request] = []
        for b in self._bindings:
            done.extend(b.engine.run(max_waves=max_waves,
                                     max_steps=max_steps))
        return done

    # -- observe (union traffic mix) -----------------------------------
    def observe(self, now: Optional[float] = None) -> TrafficMix:
        """Union traffic mix across all engines since the last observation
        (consumes the window, like the per-engine controller's). With a
        clock, the mix also carries the window's wall span so
        ``TrafficMix.tokens_per_s`` yields the observed arrival rate —
        what autoscaling provisions against."""
        window: Optional[float] = None
        if now is not None:
            if self._last_observe_t is not None:
                window = max(now - self._last_observe_t, 0.0)
            self._last_observe_t = now
        prefill = decode = slot_steps = active = 0
        for b in self._bindings:
            cur, last = b.engine.stats, self._last[b.name]
            prefill += cur.prefill_tokens - last.prefill_tokens
            decode += cur.decode_tokens - last.decode_tokens
            slot_steps += cur.slot_steps - last.slot_steps
            active += cur.active_slot_steps - last.active_slot_steps
            self._last[b.name] = cur.snapshot()
        total = prefill + decode
        weights = (("prefill", prefill / total if total else 0.0),
                   ("decode", decode / total if total else 0.0))
        occ = active / slot_steps if slot_steps else 0.0
        budgets = [s for s in (b.engine.slo_time_per_step_s()
                               for b in self._bindings) if s is not None]
        return TrafficMix(kind_weights=weights, occupancy=occ,
                          occupancy_bucket=occupancy_bucket(occ),
                          tokens=total,
                          slo_time_per_step_s=min(budgets) if budgets
                          else None,
                          window_s=window)

    # -- energy-proportional autoscaling -------------------------------
    def engine_capacity_tps(self, binding: EngineBinding) -> float:
        """Sustainable token throughput of one engine under its current
        placements: slots over the slowest per-token step time (a full
        engine emits one token per slot per step)."""
        rates = [p.time_per_token_s for p in binding.engine.placements.values()
                 if p.time_per_token_s > 0.0]
        if not rates:
            return 0.0
        return binding.engine.slots / max(rates)

    def capacity_points(self) -> list[CapacityPoint]:
        """The fleet's provisioning economics, one point per engine (an
        engine's marginal rate is its most expensive kind — conservative)."""
        return [CapacityPoint(
            name=b.name,
            energy_per_token_ws=max(
                (p.energy_per_token_ws
                 for p in b.engine.placements.values()), default=0.0),
            static_watts=b.dest.idle_watts,
            capacity_tps=self.engine_capacity_tps(b),
            order=b.order) for b in self._bindings]

    def scale_to(self, demand_tps: float, now: float) -> dict[str, str]:
        """Spin the fleet to the cheapest awake set covering ``demand_tps``
        tokens/s (x ``headroom``): engines in the provisioned set wake, the
        rest drop to the DVFS floor once idle and deep-sleep after
        ``sleep_after_s`` continuously idle seconds. An engine with queued
        or in-flight work is never forced down — it drains first and spins
        down on a later tick. Returns {engine name: power state}."""
        for b in self._bindings:
            b.engine.check_awake(now)
        target = set(provision_awake_set(
            self.capacity_points(), demand_tps,
            min_awake=self.min_awake, headroom=self.headroom))
        states: dict[str, str] = {}
        for b in self._bindings:
            eng = b.engine
            if b.name in target:
                self._idle_since.pop(b.name, None)
                if eng.power_state != "awake":
                    eng.wake(now)
            elif eng.idle:
                if eng.power_state == "awake":
                    eng.to_floor()
                    self._idle_since.setdefault(b.name, now)
                if (eng.power_state == "floor"
                        and now - self._idle_since.setdefault(b.name, now)
                        >= self.sleep_after_s):
                    eng.sleep()
            states[b.name] = eng.power_state
        return states

    def power_states(self) -> dict[str, str]:
        return {b.name: b.engine.power_state for b in self._bindings}

    # -- one shared sweep, narrowed per engine -------------------------
    def plan(self, now: Optional[float] = None) -> RouterPlanReport:
        """One shared observe → sweep → narrow → reconfigure pass for the
        whole fleet: a single ``search_fleet`` call over the union mix's
        cells on every destination, then per-engine narrowing on that
        engine's own destination cells. Re-planning the same traffic
        through the persisted cache performs zero new measurements.

        With ``autoscale=True`` and a clock, the pass also spins
        destinations down/up against the window's observed token arrival
        rate (:meth:`scale_to`) — before the early-out, so a trough window
        with no traffic still scales the fleet down."""
        mix = self.observe(now)
        report = RouterPlanReport(mix=mix, fleet=None)
        if self.autoscale and now is not None \
                and mix.tokens_per_s is not None:
            report.demand_tps = mix.tokens_per_s
            report.power_states = self.scale_to(mix.tokens_per_s, now)
        kinds = [k for k in self.catalog
                 if mix.weight(k) > self.min_kind_weight]
        if not kinds:
            self.history.append(report)
            return report

        cells: dict[tuple[str, str], CellSpec] = {}
        for kind in kinds:
            shape = scale_shape(self.catalog[kind], mix.occupancy_bucket)
            for d in self.destinations:
                cells[(kind, d.name)] = CellSpec.create(
                    self.arch, shape, d.mesh_shape, power=d.power)
        fleet = search_fleet(list(cells.values()), ga_config=self.ga_config,
                             engine=self.eval_engine, cell_workers=1)
        report.fleet = fleet
        report.new_measurements = fleet.evaluations
        by_cell = fleet.by_cell()

        # fleet-frontier dominance + staged preferred destination, per kind
        # (cross-kind dominance is meaningless: prefill and decode steps
        # live on different time/energy scales, so a destination is drained
        # only when EVERY kind's frontier rejects it). Membership is tested
        # by each destination's OWN cell key: two destinations on identical
        # silicon share a cell label by design and must share frontier fate
        # — attributing the shared cell to just one of them would falsely
        # drain the other.
        dominated = {d.name for d in self.destinations}
        for kind in kinds:
            kind_results = [by_cell[cells[(kind, d.name)].key]
                            for d in self.destinations]
            kfront = fleet_frontier(cr.search.frontier
                                    for cr in kind_results)
            kfront_cells = {p.cell for p in kfront}
            dominated &= {d.name for d in self.destinations
                          if cells[(kind, d.name)].key not in kfront_cells}
            dest_points = {d.name: [p for p in kfront
                                    if p.cell == cells[(kind, d.name)].key]
                           for d in self.destinations}
            self._stage_preferred(kind, dest_points, mix, report)
        if len(dominated) < len(self.destinations):
            report.dominated = [d.name for d in self.destinations
                                if d.name in dominated]

        for b in self._bindings:
            adopted: dict[str, Placement] = {}
            for kind in kinds:
                cr = by_cell[cells[(kind, b.dest.name)].key]
                tokens = max(cr.spec.shape.tokens(), 1)
                req = narrowing_requirement(
                    base=self.requirement,
                    require_energy_improvement=self.require_energy_improvement,
                    baseline_energy_ws=cr.search.baseline.energy_ws,
                    live=b.engine.placements.get(kind),
                    ref_tokens=tokens,
                    slo_time_per_step_s=mix.slo_time_per_step_s)
                pt = select_operating_point(cr.search.frontier, req,
                                            prefer=self.prefer)
                if pt is None:
                    continue  # keep the engine's current placement
                dec = fleet.decisions_for(pt)
                adopted[kind] = Placement(
                    kind=kind, cell=pt.cell, destination=b.dest.name,
                    decisions=dec, clock=dec.clock,
                    energy_per_token_ws=pt.energy_ws / tokens,
                    time_per_token_s=pt.time_s / tokens, source="adaptive")
            if adopted:
                b.engine.reconfigure({**b.engine.placements, **adopted})
                report.placements[b.name] = adopted
        self.history.append(report)
        return report

    def _stage_preferred(self, kind: str,
                         dest_points: dict[str, list[ParetoPoint]],
                         mix: TrafficMix, report: RouterPlanReport) -> None:
        """Staged §3.3 selection of the fleet-preferred destination for one
        kind: candidates verify cheap-to-expensive (``verify_cost_s`` from
        the catalog) over the already-swept frontier points; a destination
        whose whole frontier is dominated never charges its verify cost."""
        req = narrowing_requirement(
            base=self.requirement, require_energy_improvement=False,
            baseline_energy_ws=0.0, live=None, ref_tokens=max(
                scale_shape(self.catalog[kind],
                            mix.occupancy_bucket).tokens(), 1),
            slo_time_per_step_s=mix.slo_time_per_step_s)

        def make_search(points):
            def _search():
                pt = select_operating_point(points, req, prefer=self.prefer)
                if pt is None:
                    return None, _INFEASIBLE
                return pt, pt.measurement
            return _search

        candidates = [
            Destination(name=d.name, verify_cost_s=d.verify_cost_s,
                        search=make_search(dest_points[d.name]))
            for d in self.destinations if dest_points.get(d.name)
        ]
        if not candidates:
            return
        selection = select_destination(candidates, requirement=req)
        report.selections[kind] = selection
        if selection.chosen is not None:
            report.preferred[kind] = selection.chosen

    # -- drain / rebalance ---------------------------------------------
    def drain(self, name: str,
              survivors: Optional[Sequence[EngineBinding]] = None) -> int:
        """Migrate every *queued* (never admitted) request off engine
        ``name``, re-routing each through the policy over ``survivors``
        (default: every other engine). Admitted requests stay — their
        tokens are already billed to their admission epoch, and moving them
        would bill twice."""
        source = next(b for b in self._bindings if b.name == name)
        pool = list(survivors if survivors is not None
                    else (b for b in self._bindings if b.name != name))
        if not pool:
            return 0
        moved = 0
        while source.engine.queue:
            req = source.engine.queue.popleft()
            target = self._route(req, pool)
            # direct queue hand-off: the request was vetted at its original
            # submit and the fleet shares one max_len, so re-vetting (and
            # re-counting truncation) would distort the fleet ledger
            target.engine.queue.append(req)
            self.assignments[req.rid] = target.name
            moved += 1
        return moved

    def saturated(self) -> list[str]:
        """Engines whose queued backlog exceeds ``saturation_factor`` x
        their slot count — the spike signal live rebalancing sheds from."""
        return [b.name for b in self._bindings
                if len(b.engine.queue)
                > self.saturation_factor * b.engine.slots]

    def migrate_slot(self, source: str, slot: int, target: str,
                     now: Optional[float] = None) -> int:
        """Move ONE admitted (in-flight) request: snapshot ``slot`` off
        engine ``source`` and restore it into a free slot of ``target``
        (:mod:`repro_torch.runtime.migration` — transactional: a refusal
        leaves the source untouched). Tokens decoded after the move bill
        under the target's placement epoch; the transfer bills a separate
        ``migration_ws`` ledger line on the target; no token bills twice.
        Returns the target slot index."""
        from repro_torch.runtime.migration import migrate
        src = next(b for b in self._bindings if b.name == source)
        dst = next(b for b in self._bindings if b.name == target)
        req, _ = self._slot_request(src, slot)
        out = migrate(src.engine, dst.engine, slot, now=now)
        self.assignments[req.rid] = dst.name
        self.moves.append((req.rid, src.name, dst.name))
        return out

    def _slot_request(self, binding: EngineBinding, slot: int):
        from repro_torch.runtime import migration
        sess_kind, s = migration._session(binding.engine)
        reqs = s["slot_req"] if sess_kind == "stream" else s["reqs"]
        if slot >= len(reqs) or reqs[slot] is None:
            from repro_torch.runtime.migration import MigrationError
            raise MigrationError(
                f"slot {slot} of {binding.name!r} holds no request")
        return reqs[slot], sess_kind

    def _live_shed(self, source: EngineBinding,
                   survivors: Sequence[EngineBinding],
                   now: Optional[float]) -> int:
        """Migrate ``source``'s admitted slots (ascending slot order) onto
        awake survivors with free slots, chosen by the routing policy's
        cost (energy: marginal modeled Watt·s; latency: modeled ETA;
        catalog order breaks ties). Stops at the first slot no survivor
        can take — refusals are deterministic, not silent drops."""
        from repro_torch.runtime import migration
        moved = 0
        try:
            sess_kind, s = migration._session(source.engine)
        except migration.MigrationError:
            return 0
        reqs = s["slot_req"] if sess_kind == "stream" else s["reqs"]
        for slot in range(len(reqs)):
            req = reqs[slot]
            if req is None or (sess_kind == "wave"
                               and not s["active"][slot]):
                continue
            cands = []
            for b in survivors:
                if now is not None:
                    b.engine.check_awake(now)
                if b.engine.power_state != "awake":
                    continue
                if not migration.free_slots(b.engine):
                    continue
                cands.append(b)
            if not cands:
                return moved
            if self.policy == "latency":
                target = min(cands, key=lambda b: (self.eta_s(b, req, now),
                                                   b.order))
            else:
                target = min(cands,
                             key=lambda b: (self.marginal_energy_ws(
                                 b.engine, req), b.order))
            try:
                migration.migrate(source.engine, target.engine, slot,
                                  now=now)
            except migration.MigrationError:
                continue  # geometry refusal: try the next slot
            self.assignments[req.rid] = target.name
            self.moves.append((req.rid, source.name, target.name))
            moved += 1
        return moved

    def rebalance(self, dominated: Optional[Sequence[str]] = None, *,
                  live: bool = False, now: Optional[float] = None,
                  include_saturated: Optional[bool] = None
                  ) -> dict[str, int]:
        """Shed load off engines whose destination is dominated on the
        fleet frontier (default: the last plan's verdict) and — when
        ``include_saturated`` (default: follows ``live``) — off engines
        whose queue exceeds the saturation threshold.

        The base move is the queue drain (queued, never-admitted
        requests re-route through the policy). ``live=True`` escalates to
        **mid-flight migration of admitted requests**: occupied slots move
        to awake survivors with free capacity through
        :meth:`migrate_slot`'s billing contract (post-move tokens bill
        under the target's epoch, the transfer bills ``migration_ws``, no
        token twice). Returns {engine name: requests moved} counting both
        kinds."""
        if dominated is None:
            dominated = self.history[-1].dominated if self.history else []
        dominated = set(dominated)
        if include_saturated is None:
            include_saturated = live
        source_names = {b.name for b in self._bindings
                        if b.dest.name in dominated}
        if include_saturated:
            source_names |= set(self.saturated())
        if not source_names:
            return {}
        sources = [b for b in self._bindings if b.name in source_names]
        survivors = [b for b in self._bindings
                     if b.name not in source_names]
        if not survivors:
            return {}  # refusing to drain the whole fleet
        moved: dict[str, int] = {}
        for b in sources:
            n = self.drain(b.name, survivors)
            if live:
                n += self._live_shed(b, survivors, now)
            if n:
                moved[b.name] = n
        return moved
