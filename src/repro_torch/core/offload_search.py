"""GPU-path GA offload search drivers for both workloads, plus fleet search.

* ``search_himeno`` — the paper's literal experiment: 13-bit genome over
  loop statements, measured or calibrated backend.
* ``search_lm_cell`` — the TPU adaptation: categorical genome over execution
  decisions for an (arch × shape × mesh) cell, scored by the analytic
  verification environment (the compile-backed verifier confirms winners —
  the FPGA-path split of cheap-iterate vs expensive-confirm).
* ``search_fleet`` — many cells swept concurrently through one
  :class:`~repro_torch.core.evaluator.EvalEngine`, sharing its cross-cell
  measurement cache; per-cell and fleet-wide time/energy Pareto frontiers
  come back alongside the GA winners (see core/pareto.py). This is the
  many-applications/many-placements regime the paper's follow-ups
  (arXiv:2110.11520, arXiv:2011.12431) evaluate, one sweep per call.

Per-cell results are executor- and concurrency-independent: every cell's GA
runs its own deterministic RNG stream and every measurement backend is a pure
function of the genome, so a thread-pool fleet sweep returns bit-identical
best genomes to a serial sweep — only wall time and cache-hit accounting
differ.
"""
from __future__ import annotations

import itertools
import time
from concurrent.futures import ThreadPoolExecutor as _FuturesPool
from dataclasses import dataclass, field, replace
from typing import Callable, Optional, Sequence, Union

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.evaluator import (
    CacheStats, EvalEngine, VectorizedExecutor,
)
from repro_torch.core.fitness import Measurement, UserRequirement
from repro_torch.core.ga import GAConfig, GAResult, run_ga
from repro_torch.core.genome import Gene, GenomeSpace, binary_space
from repro_torch.core.lm_cost_model import (
    Decisions, cell_cache_key, measure_cell, measure_cell_batch,
)
from repro_torch.core.pareto import (
    ParetoPoint, fleet_frontier, pareto_frontier, select_operating_point,
)
from repro_torch.core.power import TpuPowerModel


# ---------------------------------------------------------------------------
# Himeno (paper-faithful)
# ---------------------------------------------------------------------------


def search_himeno(backend, config: Optional[GAConfig] = None) -> GAResult:
    """backend: HimenoMeasuredBackend or HimenoCalibratedBackend."""
    names = backend.unit_names()
    space = binary_space(names)
    cfg = config or GAConfig(population=min(12, len(names)),
                             generations=min(12, len(names)))
    return run_ga(space, lambda bits: backend.measure_bits(bits), cfg,
                  seed_genomes=(space.zeros(),))


# ---------------------------------------------------------------------------
# LM cells (TPU adaptation)
# ---------------------------------------------------------------------------


def lm_genome_space(cfg: ArchConfig, shape: ShapeSpec) -> GenomeSpace:
    """Masked gene set per DESIGN.md §Arch-applicability."""
    genes: list[Gene] = []
    has_attn = cfg.num_heads > 0
    if shape.kind == "train":
        genes.append(Gene("remat", ("full", "dots", "none")))
        genes.append(Gene("fsdp_params", (True, False)))
        accums = tuple(dict.fromkeys(
            (cfg.accum, max(1, cfg.accum // 2), cfg.accum * 2)))
        genes.append(Gene("accum", accums))
    if has_attn and shape.kind != "decode":
        genes.append(Gene("attn_impl", ("flash", "xla")))
    if shape.kind == "decode" and (has_attn or cfg.family == "hybrid"):
        genes.append(Gene("seq_shard_decode", (True, False)))
    genes.append(Gene("overlap", (True, False)))
    genes.append(Gene("matmul_precision", ("bf16", "f32_accum")))
    # DVFS power knob (paper's objective is Watt·s, not speed): down-clocking
    # trades step time for MXU energy, populating the Pareto frontier.
    genes.append(Gene("clock", (1.0, 0.85, 0.7)))
    return GenomeSpace(tuple(genes))


def decisions_from(space: GenomeSpace, genome: tuple[int, ...],
                   base: Decisions = Decisions()) -> Decisions:
    assignment = space.decode(genome)
    known = {f.name for f in Decisions.__dataclass_fields__.values()}
    return replace(base, **{k: v for k, v in assignment.items() if k in known})


def mesh_label(mesh_shape: dict[str, int]) -> str:
    """Canonical mesh/destination label ("data16xmodel16", ...). The single
    definition: cell keys embed it and the placement controller matches
    chosen destinations back to fleet cells by it."""
    return "x".join(f"{k}{v}" for k, v in sorted(mesh_shape.items()))


def lm_cell_key(cfg: ArchConfig, shape: ShapeSpec,
                mesh_shape: dict[str, int], seed: int = 0) -> str:
    key = f"{cfg.name}/{shape.name}/{mesh_label(mesh_shape)}"
    return f"{key}#s{seed}" if seed else key


# Custom-backend searches get unique auto-derived cell labels: two backends
# measuring the same (arch, shape, mesh) on a shared engine must never serve
# each other's cached results. Cross-run sharing for a custom backend is an
# explicit opt-in via the ``cell`` parameter.
_CUSTOM_BACKEND_CELLS = itertools.count()


@dataclass
class LmSearchResult:
    ga: GAResult
    space: GenomeSpace
    best_decisions: Decisions
    baseline: Measurement  # paper-faithful defaults, for §Perf comparison
    frontier: list[ParetoPoint] = field(default_factory=list)
    cell: str = ""


def search_lm_cell(
    cfg: ArchConfig,
    shape: ShapeSpec,
    mesh_shape: dict[str, int],
    ga_config: Optional[GAConfig] = None,
    measure: Optional[Callable[[Decisions], Measurement]] = None,
    power: TpuPowerModel = TpuPowerModel(),
    *,
    engine: Optional[EvalEngine] = None,
    cell: Optional[str] = None,
    ga_seed: int = 0,
) -> LmSearchResult:
    """One cell's GA search. Pass a shared ``engine`` to join a fleet-wide
    measurement cache; ``ga_seed`` offsets the GA's RNG (multi-start restarts
    of the same cell share every measurement through the semantic cache
    key). The returned frontier covers every runnable pattern this search
    measured, baseline included."""
    space = lm_genome_space(cfg, shape)
    analytic = measure is None
    measure = measure or (lambda dec: measure_cell(cfg, shape, mesh_shape, dec,
                                                   power=power))

    def measure_bits(genome: tuple[int, ...]) -> Measurement:
        return measure(decisions_from(space, genome))

    canonical = None
    if analytic:
        # semantic keying: distinct genomes (or cells) with identical
        # resolved execution decisions share one cache entry
        canonical = lambda g: cell_cache_key(  # noqa: E731
            cfg, shape, mesh_shape, decisions_from(space, g), power)
        measure_bits.batch = lambda genomes: measure_cell_batch(
            cfg, shape, mesh_shape,
            [decisions_from(space, g) for g in genomes], power=power)

    if cell is None:
        cell = lm_cell_key(cfg, shape, mesh_shape, seed=ga_seed)
        if not analytic:
            cell = f"{cell}@backend{next(_CUSTOM_BACKEND_CELLS)}"
    eng = engine or EvalEngine()
    n = len(space.genes)
    ga_cfg = ga_config or GAConfig(population=min(12, max(4, n * 2)),
                                   generations=min(12, max(4, n * 2)))
    if ga_seed:
        ga_cfg = replace(ga_cfg, seed=ga_cfg.seed + ga_seed)

    zero = space.encode({})
    # paper-faithful baseline (the all-defaults genome), routed through the
    # engine for EVERY backend: it shares its cache entry with the GA's
    # zero seed genome, and — for backend cells with a stable ``cell``
    # label — with previous sweeps, so a re-sweep of an expensive
    # (compile-/meter-/hardware-backed) cell really performs zero new
    # measurements, baseline included.
    [baseline], _, _ = eng.evaluate(cell, [zero], measure_bits,
                                    canonical=canonical)
    result = run_ga(space, measure_bits, ga_cfg, seed_genomes=(zero,),
                    engine=eng, cell=cell, canonical=canonical)

    by_genome: dict[tuple[int, ...], Measurement] = {zero: baseline}
    for gen in result.history:
        for r in gen:
            by_genome.setdefault(r.genome, r.measurement)
    frontier = pareto_frontier(
        ParetoPoint(g, m, cell) for g, m in by_genome.items())
    return LmSearchResult(
        ga=result, space=space,
        best_decisions=decisions_from(space, result.best.genome),
        baseline=baseline, frontier=frontier, cell=cell)


# ---------------------------------------------------------------------------
# Fleet search (many cells, one shared evaluation substrate)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CellSpec:
    """One fleet cell: (arch × shape × mesh), plus a GA restart seed so a
    fleet can include multi-start searches of the same cell (restarts share
    all measurements through the semantic cache). ``backend`` names a
    registered measurement backend (:func:`~repro_torch.core.evaluator.
    register_backend`); None means the analytic cost model. Backend-keyed
    cells get a stable ``@backend`` cache namespace, so re-sweeping the same
    backend-backed cell hits the shared (possibly disk-persisted) cache —
    model-, compile- and meter-backed cells coexist in one fleet.

    ``power`` pins the cell to a per-destination power model (a mixed
    offloading environment runs the same workload on different silicon —
    arXiv:2011.12431); None inherits ``search_fleet``'s fleet-wide model.
    The analytic cache key already includes the power model, so
    per-destination cells share nothing they shouldn't, and the cell label
    grows a stable ``@pw:`` namespace so cells with the same mesh but
    *different* power models never collide in per-cell result maps (two
    destinations on identical mesh AND identical coefficients share one
    label by design — they are the same cell)."""

    arch: str
    shape: ShapeSpec
    mesh: tuple[tuple[str, int], ...]  # sorted (axis, size) items
    seed: int = 0
    backend: Optional[str] = None
    power: Optional[TpuPowerModel] = None

    @staticmethod
    def create(arch: str, shape: Union[str, ShapeSpec],
               mesh_shape: dict[str, int], seed: int = 0,
               backend: Optional[str] = None,
               power: Optional[TpuPowerModel] = None) -> "CellSpec":
        if isinstance(shape, str):
            from repro_torch.configs import SHAPES
            shape = SHAPES[shape]
        return CellSpec(arch, shape, tuple(sorted(mesh_shape.items())), seed,
                        backend, power)

    @property
    def mesh_shape(self) -> dict[str, int]:
        return dict(self.mesh)

    @property
    def key(self) -> str:
        from repro_torch.configs import get_config
        key = lm_cell_key(get_config(self.arch), self.shape, self.mesh_shape,
                          seed=self.seed)
        if self.backend:
            key = f"{key}@{self.backend}"
        if self.power is not None:
            key = f"{key}@pw:{self.power.tag}"
        return key


@dataclass
class FleetCellResult:
    spec: CellSpec
    cell: str
    search: LmSearchResult
    operating_point: Optional[ParetoPoint]
    wall_s: float


@dataclass
class FleetResult:
    cells: list[FleetCellResult]  # input order (screened-out cells absent)
    frontier: list[ParetoPoint]  # fleet-wide non-dominated placements
    cache: CacheStats  # this sweep's shared-cache traffic (delta)
    evaluations: int  # distinct measurements actually performed
    cache_hits: int
    wall_s: float
    # Static pre-screen outcome (analysis/screen.py ScreenReport) when
    # search_fleet ran with screen=...; None means every cell was measured.
    screen: Optional[object] = None

    @property
    def cache_hit_rate(self) -> float:
        return self.cache.hit_rate

    def by_cell(self) -> dict[str, FleetCellResult]:
        return {cr.cell: cr for cr in self.cells}

    def decisions_for(self, point: ParetoPoint) -> Decisions:
        """Resolve a frontier point back to executable ``Decisions`` through
        its cell's genome space (frontier points only carry raw genomes)."""
        cr = self.by_cell()[point.cell]
        return decisions_from(cr.search.space, point.genome)


def search_fleet(
    cells: Sequence[CellSpec],
    *,
    ga_config: Optional[GAConfig] = None,
    engine: Optional[EvalEngine] = None,
    cell_workers: int = 4,
    requirement: Optional[UserRequirement] = None,
    power: TpuPowerModel = TpuPowerModel(),
    screen=None,
) -> FleetResult:
    """Sweep many (arch × shape × mesh) cells concurrently.

    All cells evaluate through one shared ``engine`` (default: vectorized
    batches into a fresh cross-cell cache — right for the µs-cheap analytic
    backend, where a thread pool would only add GIL overhead; pass a
    ``ThreadedExecutor`` engine for blocking verifier backends, or a
    persistent engine to keep measurements across sweeps). ``cell_workers``
    > 1 runs whole cells concurrently on top of the engine's
    intra-generation batching; ``requirement`` narrows each cell's frontier
    to a preferred operating point (lowest energy satisfying the
    requirement, the paper's §3.3 flow).

    ``screen`` — pass ``True`` or an ``analysis.screen.ScreenPolicy`` to
    run the static pre-screen first: cells it proves dead (infeasible /
    dominated / below the intensity floor) are dropped before measurement
    and recorded on ``FleetResult.screen`` + ``engine.screened_cells``.
    Survivors' GA winners, operating points, and the fleet frontier are
    bit-identical to the unscreened sweep (the screen's dominance proof
    quantifies over the dropped cells' whole genome spaces).
    """
    from repro_torch.configs import get_config

    eng = engine or EvalEngine(executor=VectorizedExecutor())
    screen_report = None
    if screen:
        from repro_torch.analysis.screen import ScreenPolicy, screen_cells
        policy = screen if isinstance(screen, ScreenPolicy) else None
        screen_report = screen_cells(cells, policy=policy, power=power)
        cells = screen_report.kept
        eng.note_screened([d.key for d in screen_report.dropped])
    stats_before = eng.cache.stats()
    t_start = time.perf_counter()

    def run_cell(spec: CellSpec) -> FleetCellResult:
        t0 = time.perf_counter()
        cfg = get_config(spec.arch)
        cell_power = spec.power if spec.power is not None else power
        measure = cell_label = None
        if spec.backend:
            from repro_torch.core.evaluator import get_backend
            measure = get_backend(spec.backend)(cfg, spec.shape,
                                                spec.mesh_shape, cell_power)
            cell_label = spec.key  # stable: re-sweeps hit the shared cache
        elif spec.power is not None:
            # analytic cell pinned to a destination power model: the label's
            # @pw: namespace keeps per-cell results apart; the semantic cache
            # key already embeds the power model, so caching stays exact
            cell_label = spec.key
        res = search_lm_cell(cfg, spec.shape, spec.mesh_shape, ga_config,
                             measure=measure, power=cell_power, engine=eng,
                             cell=cell_label, ga_seed=spec.seed)
        req = requirement
        if req is not None and req.min_speedup is not None \
                and req.baseline_time_s is None:
            # speedup is relative to *this cell's* baseline (§3.3): a fleet
            # spans step times orders of magnitude apart, so a single
            # fleet-wide baseline would be wrong for every cell but one
            req = replace(req, baseline_time_s=res.baseline.time_s)
        op = select_operating_point(res.frontier, req)
        return FleetCellResult(spec, res.cell, res, op,
                               time.perf_counter() - t0)

    if cell_workers > 1 and len(cells) > 1:
        with _FuturesPool(max_workers=min(cell_workers, len(cells))) as pool:
            results = list(pool.map(run_cell, cells))
    else:
        results = [run_cell(c) for c in cells]

    delta = eng.cache.stats().since(stats_before)
    return FleetResult(
        cells=results,
        frontier=fleet_frontier(r.search.frontier for r in results),
        cache=delta,
        evaluations=delta.inserts,
        cache_hits=delta.hits,
        wall_s=time.perf_counter() - t_start,
        screen=screen_report)
