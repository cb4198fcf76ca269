"""Traffic-adaptive placement controller: observe → sweep → narrow → reconfigure.

This is the serving↔search integration the paper's flow implies (§3.3): the
environment-adaptation loop should pick the low-Watt·s operating point
*automatically*, reacting to what the serving layer is actually doing rather
than to a hand-chosen offline cell. The controller closes that loop:

1. **observe** — snapshot the :class:`~repro_torch.runtime.serving.EngineStats`
   delta since the last sweep: the traffic mix over shape kinds
   (prefill vs decode token shares), the batch occupancy of the scheduler,
   and the tightest per-step time budget implied by pending request SLOs.
   Occupancy is quantized into quarter buckets so observed cells form a
   small stable set and the measurement cache stays hot. Under the
   slot-stream scheduler the window is a **step count** (``interval_steps``
   via the engine's ``on_step_end`` hook — there are no wave boundaries);
   under the wave scheduler it stays ``interval_waves``.
2. **sweep** — map the observed mix to fleet cells (arch × bucketed shape ×
   candidate destination mesh) and run
   :func:`~repro_torch.core.offload_search.search_fleet` over them through an
   :class:`~repro_torch.core.evaluator.EvalEngine` whose cache is disk-persisted
   (:class:`~repro_torch.core.cache_store.PersistentEvalCache`): every sweep in
   every process shares one measurement history, so steady-state traffic
   re-plans with zero new measurements.
3. **narrow** — per shape kind, merge the candidate destinations' frontiers
   into a kind-level :func:`~repro_torch.core.pareto.fleet_frontier` (placements
   dominated by another destination drop out) and run the paper's staged
   mixed-environment selection (:func:`~repro_torch.core.device_select.
   select_destination`) over the surviving destinations in cheap-to-expensive
   order. The user requirement (default: "no worse Watt·s than the cell's
   paper-faithful baseline") early-exits on the first satisfying
   destination; when the observed traffic carries request SLOs the implied
   per-step time budget joins as ``max_time_s`` (multi-requirement §3.3:
   time SLO and energy jointly, as in mixed-destination selection). The
   chosen pattern fixes cell, destination *and* the DVFS clock gene jointly.
4. **reconfigure** — apply the chosen :class:`Placement`s to the engine.
   Under slot streams the swap applies to newly admitted slots (in-flight
   requests keep their admission epoch), so it is safe mid-run; the wave
   scheduler keeps the between-waves-only rule.

Counterpart of the JAX package's ``runtime/placement.py``, which is pure
Python: a copy over the port's ``core`` and ``runtime.serving``, so plans,
placements and ledgers are bit-identical to the reference's. The Watt·s it
prices are ``TpuPowerModel``'s (a TPU v5e model), not the card's: the card's
own draw comes from ``repro_torch.telemetry`` and enters through
:meth:`PlacementController.note_metered`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.core.device_select import Destination, SelectionReport, \
    select_destination
from repro_torch.core.evaluator import EvalEngine, VectorizedExecutor
from repro_torch.core.cache_store import PersistentEvalCache
from repro_torch.core.fitness import Measurement, UserRequirement
from repro_torch.core.ga import GAConfig
from repro_torch.core.lm_cost_model import Decisions, measure_cell
from repro_torch.core.offload_search import (
    CellSpec, FleetResult, lm_cell_key, mesh_label, search_fleet,
)
from repro_torch.core.pareto import (
    ParetoPoint, fleet_frontier, frontier_by_cell, select_operating_point,
)
from repro_torch.core.power import TpuPowerModel
from repro_torch.runtime.serving import Placement, ServingEngine

# Shape catalog the observer maps live traffic onto: one production cell per
# serving shape kind ("train" cells are the offline fleet's business).
DEFAULT_CATALOG: dict[str, ShapeSpec] = {
    "prefill": SHAPES["prefill_32k"],
    "decode": SHAPES["decode_32k"],
}

# Candidate destination meshes (single source for the serve CLI and the
# serving benchmark): the production single-pod slice and its 2-pod variant.
DEFAULT_MESH_OPTIONS: tuple[dict[str, int], ...] = (
    {"data": 16, "model": 16},
    {"pod": 2, "data": 16, "model": 16},
)

_INFEASIBLE = Measurement(time_s=0.0, energy_ws=0.0, feasible=False)


@dataclass(frozen=True)
class TrafficMix:
    """One observation window of engine traffic."""

    kind_weights: tuple[tuple[str, float], ...]  # token share per shape kind
    occupancy: float  # mean active-slot fraction over the window
    occupancy_bucket: float  # quantized to quarters (cache-stable cells)
    tokens: int  # tokens seen in the window
    # tightest per-step time budget implied by pending request SLOs (None
    # when no queued/in-flight request carries one) — joins the narrowing
    # requirement as max_time_s
    slo_time_per_step_s: Optional[float] = None
    # wall-clock (or virtual-clock) seconds the window covered — set when
    # the observer is driven on a clock (FleetRouter.observe(now=...));
    # None on the legacy clockless paths. With it, the mix carries the
    # observed arrival *rate*, which is what energy-proportional
    # autoscaling sizes the awake set against.
    window_s: Optional[float] = None

    def weight(self, kind: str) -> float:
        return dict(self.kind_weights).get(kind, 0.0)

    @property
    def tokens_per_s(self) -> Optional[float]:
        """Observed token throughput demand over the window (None without
        a clocked window)."""
        if self.window_s is None or self.window_s <= 0.0:
            return None
        return self.tokens / self.window_s


def occupancy_bucket(occupancy: float) -> float:
    """Quantize occupancy to (0.25, 0.5, 0.75, 1.0] quarters."""
    if occupancy <= 0.0:
        return 0.25
    return min(1.0, math.ceil(occupancy * 4) / 4)


def scale_shape(base: ShapeSpec, bucket: float) -> ShapeSpec:
    """Catalog shape scaled to an observed batch-occupancy bucket (shared by
    the per-engine controller and the fleet router, so both map the same
    traffic onto the same cache-stable cells)."""
    gb = max(1, int(round(base.global_batch * bucket)))
    if gb == base.global_batch:
        return base
    return replace(base, name=f"{base.name}@occ{int(bucket * 100)}",
                   global_batch=gb)


def narrowing_requirement(
    *,
    base: Optional[UserRequirement],
    require_energy_improvement: bool,
    baseline_energy_ws: float,
    live: Optional[Placement],
    ref_tokens: int,
    slo_time_per_step_s: Optional[float],
) -> Optional[UserRequirement]:
    """The §3.3 narrowing requirement shared by the per-engine controller
    and the fleet router.

    With no explicit ``base`` requirement and ``require_energy_improvement``
    set, narrow to placements at least as good (Watt·s) as the cell's
    paper-faithful ``baseline_energy_ws`` AND no worse per token than the
    ``live`` placement currently applied — an occupancy-scaled cell's own
    baseline can be less efficient per token than the live placement
    (smaller batches amortize the fixed parameter traffic over fewer
    tokens), and adopting it would make "adaptive" lose to static. A
    pending-SLO per-step time budget joins as ``max_time_s`` (a cell
    measurement covers ``ref_tokens`` tokens and a serving step consumes
    one token per request, so the budget scales by ``ref_tokens``) — the
    multi-requirement case: time SLO and energy jointly."""
    req = base
    if req is None and require_energy_improvement:
        cap = baseline_energy_ws
        if live is not None:
            cap = min(cap, live.energy_per_token_ws * ref_tokens)
        req = UserRequirement(max_energy_ws=cap)
    if slo_time_per_step_s is not None:
        cap_t = slo_time_per_step_s * ref_tokens
        if req is None:
            req = UserRequirement(max_time_s=cap_t)
        elif req.max_time_s is None or req.max_time_s > cap_t:
            req = replace(req, max_time_s=cap_t)
    return req


@dataclass
class PlanReport:
    """Introspection record of one observe→sweep→narrow→reconfigure pass."""

    mix: TrafficMix
    fleet: Optional[FleetResult]
    selections: dict[str, SelectionReport] = field(default_factory=dict)
    placements: dict[str, Placement] = field(default_factory=dict)
    new_measurements: int = 0


def _chips(mesh_shape: dict[str, int]) -> int:
    n = 1
    for v in mesh_shape.values():
        n *= v
    return n


def static_placements(
    arch: str,
    mesh_shape: dict[str, int],
    *,
    catalog: Optional[dict[str, ShapeSpec]] = None,
    power: TpuPowerModel = TpuPowerModel(),
    destination: Optional[str] = None,
) -> dict[str, Placement]:
    """Paper-faithful default placement (``Decisions()`` at nominal clock on
    one fixed mesh) — the static baseline the adaptive loop competes with.
    ``destination`` overrides the reported label (the fleet router labels
    placements with catalog destination names, not raw mesh labels);
    ``power`` prices the cell on that destination's silicon."""
    cfg = get_config(arch)
    out: dict[str, Placement] = {}
    for kind, shape in (catalog or DEFAULT_CATALOG).items():
        m = measure_cell(cfg, shape, mesh_shape, Decisions(), power=power)
        tokens = max(shape.tokens(), 1)
        out[kind] = Placement(
            kind=kind, cell=lm_cell_key(cfg, shape, mesh_shape),
            destination=destination or mesh_label(mesh_shape),
            decisions=Decisions(),
            clock=1.0, energy_per_token_ws=m.energy_ws / tokens,
            time_per_token_s=m.time_s / tokens, source="static")
    return out


class PlacementController:
    """Drives ``search_fleet`` placement from the live serving loop.

    Attach to a :class:`ServingEngine` and every ``interval_waves`` waves the
    controller re-plans from the traffic observed since its last sweep. All
    sweeps share ``eval_engine``'s (optionally disk-persisted) measurement
    cache.
    """

    def __init__(
        self,
        engine: ServingEngine,
        arch: str,
        mesh_options: Sequence[dict[str, int]],
        *,
        cache_path: Optional[str] = "results/eval_cache.jsonl",
        cache_compact: bool = True,
        eval_engine: Optional[EvalEngine] = None,
        ga_config: Optional[GAConfig] = None,
        requirement: Optional[UserRequirement] = None,
        require_energy_improvement: bool = True,
        catalog: Optional[dict[str, ShapeSpec]] = None,
        power: TpuPowerModel = TpuPowerModel(),
        interval_waves: int = 4,
        interval_steps: int = 32,
        min_kind_weight: float = 0.02,
        prefer: str = "energy",
        drift_threshold: float = 0.2,
        calibrate_ledger: bool = True,
    ) -> None:
        if not mesh_options:
            raise ValueError("need at least one candidate destination mesh")
        self.engine = engine
        self.arch = arch
        self.cfg = get_config(arch)
        self.mesh_options = [dict(m) for m in mesh_options]
        if eval_engine is None:
            if cache_path:
                # cache_compact=False is the safe setting when SEVERAL live
                # processes share one cache file: construction-time
                # compaction unlinks the file under a concurrent appender's
                # open handle (see CacheStore.load); single-writer
                # deployments keep the default and their results/ file
                # stops accumulating duplicate/torn lines
                eval_engine = EvalEngine(
                    executor=VectorizedExecutor(),
                    cache=PersistentEvalCache(cache_path,
                                              compact=cache_compact))
            else:
                eval_engine = EvalEngine(executor=VectorizedExecutor())
        self.eval_engine = eval_engine
        self.ga_config = ga_config or GAConfig(population=10, generations=8)
        self.requirement = requirement
        self.require_energy_improvement = require_energy_improvement
        self.catalog = dict(catalog or DEFAULT_CATALOG)
        self.power = power
        self.interval_waves = interval_waves
        self.interval_steps = interval_steps
        self.min_kind_weight = min_kind_weight
        self.prefer = prefer
        self.drift_threshold = drift_threshold
        self.calibrate_ledger = calibrate_ledger
        self.drift: dict[str, float] = {}  # kind -> (metered/modeled) - 1
        self.history: list[PlanReport] = []
        self._last_stats = engine.stats.snapshot()
        self._waves_since = 0
        self._steps_since = 0
        self._resweep_pending = False

    # -- wiring --------------------------------------------------------
    def attach(self) -> "PlacementController":
        """Register on the engine's observation hooks: ``on_wave_end``
        (wave scheduler, ``interval_waves`` window) and ``on_step_end``
        (slot streams have no wave boundaries — the window is
        ``interval_steps`` engine steps). Each scheduler only fires its own
        hook, so the windows never double-count."""
        self.engine.on_wave_end = self._on_wave_end
        if hasattr(self.engine, "on_step_end"):
            self.engine.on_step_end = self._on_step_end
        return self

    def _on_wave_end(self, engine: ServingEngine) -> None:
        self._waves_since += 1
        if self._resweep_pending or self._waves_since >= self.interval_waves:
            self._waves_since = 0
            self._resweep_pending = False
            self.update()

    def _on_step_end(self, engine: ServingEngine) -> None:
        self._steps_since += 1
        if self._resweep_pending or self._steps_since >= self.interval_steps:
            self._steps_since = 0
            self._resweep_pending = False
            self.update()

    # -- metered feedback (telemetry drift hook) -----------------------
    def note_metered(self, kind: str, metered_ws_per_token: float) -> bool:
        """Feed a *metered* Watt·s/token (telemetry/meter.py over live
        traffic) back into the loop for one shape kind.

        Two effects: the engine's energy ledger is recalibrated by the
        metered/modeled ratio (so accumulated Watt·s track the measurement,
        not the model), and when the drift exceeds ``drift_threshold`` a
        re-sweep is scheduled for the next between-waves point regardless of
        ``interval_waves`` — the model the current placement was chosen by
        has been falsified by measurement, so the choice itself is suspect.
        Returns True when a re-sweep was triggered.
        """
        p = self.engine.placements.get(kind)
        if p is None or p.energy_per_token_ws <= 0.0 \
                or metered_ws_per_token <= 0.0:
            # a zero metered rate is a failed/empty measurement, not a free
            # placement — correcting the ledger by 0 would stop it entirely
            return False
        ratio = metered_ws_per_token / p.energy_per_token_ws
        self.drift[kind] = ratio - 1.0
        if self.calibrate_ledger:
            self.engine.energy_correction[kind] = ratio
        if abs(ratio - 1.0) > self.drift_threshold:
            self._resweep_pending = True
            return True
        return False

    # -- observe -------------------------------------------------------
    def observe(self) -> TrafficMix:
        """Traffic mix since the previous observation (consumes the window)."""
        cur = self.engine.stats
        last = self._last_stats
        prefill = cur.prefill_tokens - last.prefill_tokens
        decode = cur.decode_tokens - last.decode_tokens
        slot_steps = cur.slot_steps - last.slot_steps
        active = cur.active_slot_steps - last.active_slot_steps
        self._last_stats = cur.snapshot()
        total = prefill + decode
        weights = (("prefill", prefill / total if total else 0.0),
                   ("decode", decode / total if total else 0.0))
        occ = active / slot_steps if slot_steps else 0.0
        slo_fn = getattr(self.engine, "slo_time_per_step_s", None)
        return TrafficMix(kind_weights=weights, occupancy=occ,
                          occupancy_bucket=occupancy_bucket(occ),
                          tokens=total,
                          slo_time_per_step_s=slo_fn() if slo_fn else None)

    def shape_for(self, kind: str, bucket: float) -> ShapeSpec:
        """Catalog shape scaled to the observed batch-occupancy bucket."""
        return scale_shape(self.catalog[kind], bucket)

    # -- sweep + narrow ------------------------------------------------
    def plan(self, mix: TrafficMix) -> PlanReport:
        """Sweep the observed cells and pick per-kind placements jointly:
        cell (observed kind × occupancy), destination (candidate mesh) and
        operating point (pattern incl. DVFS clock)."""
        report = PlanReport(mix=mix, fleet=None)
        kinds = [k for k in self.catalog
                 if mix.weight(k) > self.min_kind_weight]
        if not kinds:
            return report

        cells = [CellSpec.create(self.arch,
                                 self.shape_for(kind, mix.occupancy_bucket),
                                 mesh)
                 for kind in kinds for mesh in self.mesh_options]
        fleet = search_fleet(cells, ga_config=self.ga_config,
                             engine=self.eval_engine, cell_workers=1,
                             power=self.power)
        report.fleet = fleet
        report.new_measurements = fleet.evaluations

        for kind in kinds:
            kind_results = [cr for cr in fleet.cells
                            if cr.spec.shape.kind == kind]
            placement = self._narrow_kind(kind, kind_results, fleet, report,
                                          mix=mix)
            if placement is not None:
                report.placements[kind] = placement
        return report

    def _narrow_kind(self, kind: str, kind_results, fleet: FleetResult,
                     report: PlanReport,
                     mix: Optional[TrafficMix] = None) -> Optional[Placement]:
        """Feed the kind-level fleet frontier through the paper's staged
        destination selection; returns None to keep the current placement."""
        if not kind_results:
            return None
        # placements dominated across destinations drop out here: a mesh
        # whose whole frontier is dominated contributes nothing downstream
        kfront = fleet_frontier(cr.search.frontier for cr in kind_results)
        by_cell = frontier_by_cell(kfront)

        ref = next((cr for cr in kind_results
                    if cr.spec.mesh_shape == self.mesh_options[0]),
                   kind_results[0])
        ref_tokens = max(ref.spec.shape.tokens(), 1)
        # default §3.3 requirement: at least as good (Watt·s) as the default
        # destination's paper-faithful baseline for this cell AND no worse
        # per token than the live placement, with any pending-SLO time
        # budget joining as max_time_s (see narrowing_requirement)
        req = narrowing_requirement(
            base=self.requirement,
            require_energy_improvement=self.require_energy_improvement,
            baseline_energy_ws=ref.search.baseline.energy_ws,
            live=self.engine.placements.get(kind),
            ref_tokens=ref_tokens,
            slo_time_per_step_s=(mix.slo_time_per_step_s
                                 if mix is not None else None))

        def make_search(cr):
            points = by_cell.get(cr.cell, [])

            def _search():
                pt = select_operating_point(points, req, prefer=self.prefer)
                if pt is None:
                    return None, _INFEASIBLE
                return pt, pt.measurement

            return _search

        destinations = [
            Destination(name=mesh_label(cr.spec.mesh_shape),
                        # stand-in verification cost: bigger slices are the
                        # expensive-to-verify targets (paper: CPU < GPU < FPGA)
                        verify_cost_s=float(_chips(cr.spec.mesh_shape)),
                        search=make_search(cr))
            for cr in kind_results
            # a mesh whose whole frontier is dominated drops out before
            # staged verification — no verify cost is ever charged for it
            if cr.cell in by_cell
        ]
        if not destinations:
            return None
        selection = select_destination(destinations, requirement=req)
        report.selections[kind] = selection
        if selection.chosen is None:
            return None
        chosen_pt = selection.patterns[selection.chosen]
        if not isinstance(chosen_pt, ParetoPoint):
            return None
        cr = next(c for c in kind_results
                  if mesh_label(c.spec.mesh_shape) == selection.chosen)
        dec = fleet.decisions_for(chosen_pt)
        tokens = max(cr.spec.shape.tokens(), 1)
        return Placement(
            kind=kind, cell=chosen_pt.cell, destination=selection.chosen,
            decisions=dec, clock=dec.clock,
            energy_per_token_ws=chosen_pt.energy_ws / tokens,
            time_per_token_s=chosen_pt.time_s / tokens, source="adaptive")

    # -- reconfigure ---------------------------------------------------
    def update(self) -> PlanReport:
        """One full observe → sweep → narrow → reconfigure pass."""
        mix = self.observe()
        report = self.plan(mix)
        self.history.append(report)
        if report.placements:
            self.engine.reconfigure({**self.engine.placements,
                                     **report.placements})
            for kind in report.placements:
                # a fresh placement resets the metered feedback: the old
                # correction ratio belonged to the placement it was measured
                # against, and applying it to the new one would skew the
                # ledger until the next note_metered
                self.engine.energy_correction.pop(kind, None)
                self.drift.pop(kind, None)
        return report
