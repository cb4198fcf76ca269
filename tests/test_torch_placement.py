"""The port's cost model, Pareto sets, fleet search, placements and serve()
against the JAX package's, on the CPU.

These layers are pure Python in both packages, so they must agree bit for
bit: every float compares with ``==``. Results are compared as plain nested
tuples (dataclasses by class name and fields; dicts in their order), with
wall-clock fields (``wall_s``) left out. Engines serve the reduced
llama3.2-3b in float32 on the reference's weights, carried across, so that
tokens, and with them the traffic the controller observes, are the same.
``serve()`` is compared on its own reduced config (bfloat16), with the
port's ``init_params`` replaced by the reference's weights.
"""
import dataclasses
import functools
import importlib
import types

import jax
import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from repro import models as RM
from repro import runtime as RR
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import list_configs as ref_list_configs
from repro.configs import reduced as ref_reduced
from repro.core import arithmetic_intensity as RAI
from repro.core import device_select as RDS
from repro.core import lm_cost_model as RLM
from repro.core import offload_search as ROS
from repro.core import pareto as RP
from repro.core.evaluator import EvalEngine as RefEvalEngine
from repro.core.evaluator import VectorizedExecutor as RefVectorized
from repro.core.ga import GAConfig as RefGAConfig
from repro.launch import serve as ref_serve_mod
from repro.runtime import placement as RPL
from repro_torch import models as M
from repro_torch import runtime as PR
from repro_torch.configs import SHAPES, get_config, list_configs, reduced
from repro_torch.core import arithmetic_intensity as AI
from repro_torch.core import device_select as DS
from repro_torch.core import lm_cost_model as LM
from repro_torch.core import offload_search as OS
from repro_torch.core import pareto as P
from repro_torch.core.evaluator import EvalEngine, VectorizedExecutor
from repro_torch.core.ga import GAConfig
from repro_torch.launch import serve as serve_mod
from repro_torch.runtime import placement as PL

# the packages' ``core`` exports a ``fitness`` function under the module's name
RF = importlib.import_module("repro.core.fitness")
F = importlib.import_module("repro_torch.core.fitness")
ARCHS = ref_list_configs()
DECISIONS = (
    {},
    {"clock": 0.7},
    {"clock": 0.85, "overlap": False},
    {"attn_impl": "xla", "matmul_precision": "f32_accum"},
    {"remat": "none", "fsdp_params": False, "accum": 2},
    {"seq_shard_decode": False, "remat": "dots"},
)
WALL = frozenset({"wall_s"})


def _plain(x, skip=WALL):
    """Nested tuples of plain values: dataclasses by class name and fields
    (minus ``skip``), dicts in insertion order."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, _plain(getattr(x, f.name), skip))
            for f in dataclasses.fields(x) if f.name not in skip)
    if isinstance(x, dict):
        return ("dict",) + tuple((_plain(k, skip), _plain(v, skip))
                                 for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_plain(v, skip) for v in x)
    if callable(x):
        return "callable"
    return x


def test_package_surfaces_match():
    assert list_configs() == ARCHS
    assert list(SHAPES) == list(REF_SHAPES)
    assert _plain(PL.DEFAULT_MESH_OPTIONS) == _plain(RPL.DEFAULT_MESH_OPTIONS)
    assert _plain(PL.DEFAULT_CATALOG) == _plain(RPL.DEFAULT_CATALOG)
    from repro import core as ref_core
    from repro_torch import core
    # what the reference's core exports of the modules this slice ports
    ported = {"Decisions", "analyze_cell", "canonical_decisions",
              "cell_cache_key", "measure_cell", "measure_cell_batch",
              "ParetoPoint", "dominates", "fleet_frontier",
              "frontier_by_cell", "narrow", "pareto_frontier",
              "select_operating_point", "CellSpec", "FleetCellResult",
              "FleetResult", "lm_cell_key", "lm_genome_space", "mesh_label",
              "search_fleet", "search_lm_cell", "Destination",
              "select_destination"}
    assert ported <= set(ref_core.__all__) & set(core.__all__)
    # candidates.py came with slice 4b: the port's core exports them all
    assert set(ref_core.__all__) - set(core.__all__) == set()


# ---------------------------------------------------------------------------
# Cost model: every config x shape x mesh, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_cost_model_bit_identical(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert _plain(cfg) == _plain(rcfg)
    for name, shape in SHAPES.items():
        rshape = REF_SHAPES[name]
        assert _plain(AI.lm_unit_costs(cfg, shape)) \
            == _plain(RAI.lm_unit_costs(rcfg, rshape))
        assert AI.forward_flops(cfg, shape) == RAI.forward_flops(rcfg, rshape)
        assert AI.model_flops(cfg, shape) == RAI.model_flops(rcfg, rshape)
        for remat in ("none", "dots", "full"):
            assert AI.step_flops(cfg, shape, remat) \
                == RAI.step_flops(rcfg, rshape, remat)
        for mesh in PL.DEFAULT_MESH_OPTIONS:
            decs = [LM.Decisions(**kw) for kw in DECISIONS]
            rdecs = [RLM.Decisions(**kw) for kw in DECISIONS]
            for dec, rdec in zip(decs, rdecs):
                assert _plain(LM.analyze_cell(cfg, shape, mesh, dec)) \
                    == _plain(RLM.analyze_cell(rcfg, rshape, mesh, rdec))
                assert _plain(LM.measure_cell(cfg, shape, mesh, dec)) \
                    == _plain(RLM.measure_cell(rcfg, rshape, mesh, rdec))
                assert _plain(LM.cell_cache_key(cfg, shape, mesh, dec)) \
                    == _plain(RLM.cell_cache_key(rcfg, rshape, mesh, rdec))
            assert _plain(LM.measure_cell_batch(cfg, shape, mesh, decs)) \
                == _plain(RLM.measure_cell_batch(rcfg, rshape, mesh, rdecs))
            assert OS.lm_cell_key(cfg, shape, mesh, seed=3) \
                == ROS.lm_cell_key(rcfg, rshape, mesh, seed=3)
        assert _plain(OS.lm_genome_space(cfg, shape)) \
            == _plain(ROS.lm_genome_space(rcfg, rshape))


def test_himeno_unit_costs_unchanged():
    for grid in ((65, 65, 129), (513, 257, 257)):
        assert _plain(AI.himeno_unit_costs(grid, 3)) \
            == _plain(RAI.himeno_unit_costs(grid, 3))


# ---------------------------------------------------------------------------
# Pareto sets and staged destination selection: properties over seeds
# ---------------------------------------------------------------------------


def _points(mod, fmod, rng, n, cells):
    """n points on a coarse grid (so ties and duplicates occur), some
    infeasible or timed out, spread over ``cells``."""
    pts = []
    for i in range(n):
        t = float(rng.integers(1, 12)) * 0.25
        e = float(rng.integers(1, 12)) * 1.5
        flag = rng.integers(0, 10)
        m = fmod.Measurement(time_s=t, energy_ws=e, timed_out=flag == 0,
                             feasible=flag != 1)
        pts.append(mod.ParetoPoint((i, int(flag)), m,
                                   cells[int(rng.integers(len(cells)))]))
    return pts


def _requirements(fmod):
    return [None, fmod.UserRequirement(max_time_s=1.5),
            fmod.UserRequirement(max_energy_ws=6.0),
            fmod.UserRequirement(max_time_s=2.0, max_energy_ws=9.0),
            fmod.UserRequirement(min_speedup=2.0, baseline_time_s=3.0),
            fmod.UserRequirement(min_speedup=2.0),
            fmod.UserRequirement(max_time_s=0.1)]


@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=25, deadline=None)
def test_pareto_functions_bit_identical(seed):
    cells = ["a", "b", "c"]
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 40))
    pts = _points(P, F, np.random.default_rng(seed), n, cells)
    rpts = _points(RP, RF, np.random.default_rng(seed), n, cells)
    front = P.pareto_frontier(pts)
    assert _plain(front) == _plain(RP.pareto_frontier(rpts))
    # the frontier's own properties: runnable, mutually non-dominated,
    # covering every runnable point
    for p in front:
        assert p.measurement.feasible and not p.measurement.timed_out
        assert not any(P.dominates(q.measurement, p.measurement)
                       for q in pts if q.measurement.feasible
                       and not q.measurement.timed_out)
    for q in pts:
        if q.measurement.feasible and not q.measurement.timed_out:
            assert any(p.time_s <= q.time_s and p.energy_ws <= q.energy_ws
                       for p in front)
    for a, ra in zip(pts[:8], rpts[:8]):
        for b, rb in zip(pts[:8], rpts[:8]):
            assert P.dominates(a.measurement, b.measurement) \
                == RP.dominates(ra.measurement, rb.measurement)
    per = [[p for p in pts if p.cell == c] for c in cells]
    rper = [[p for p in rpts if p.cell == c] for c in cells]
    fleet = P.fleet_frontier(P.pareto_frontier(c) for c in per)
    rfleet = RP.fleet_frontier(RP.pareto_frontier(c) for c in rper)
    assert _plain(fleet) == _plain(rfleet)
    assert _plain(P.frontier_by_cell(fleet)) \
        == _plain(RP.frontier_by_cell(rfleet))
    dest = {"a": "x", "b": "y", "c": "x"}
    assert _plain(P.frontier_by_destination(fleet, lambda p: dest[p.cell])) \
        == _plain(RP.frontier_by_destination(rfleet,
                                             lambda p: dest[p.cell]))
    assert P.dominated_destinations(["x", "y", "z"], fleet,
                                    lambda p: dest[p.cell]) \
        == RP.dominated_destinations(["x", "y", "z"], rfleet,
                                     lambda p: dest[p.cell])
    for req, rreq in zip(_requirements(F), _requirements(RF)):
        assert _plain(P.narrow(pts, req)) == _plain(RP.narrow(rpts, rreq))
        for prefer in ("energy", "time", "fitness"):
            assert _plain(P.select_operating_point(pts, req, prefer)) \
                == _plain(RP.select_operating_point(rpts, rreq, prefer))


def _capacity(mod, rng, n):
    return [mod.CapacityPoint(f"d{i}", float(rng.integers(1, 6)) * 0.5,
                              float(rng.integers(0, 5)) * 10.0,
                              float(rng.integers(0, 4)) * 100.0,
                              order=int(rng.integers(0, 3)))
            for i in range(n)]


@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=25, deadline=None)
def test_capacity_functions_bit_identical(seed):
    n = int(np.random.default_rng(seed).integers(0, 8)) + 1
    cands = _capacity(P, np.random.default_rng(seed), n)
    rcands = _capacity(RP, np.random.default_rng(seed), n)
    for demand in (0.0, 50.0, 250.0, 1e4, -1.0):
        for min_awake, headroom in ((1, 1.0), (0, 1.5), (3, 0.5)):
            assert P.provision_awake_set(cands, demand, min_awake=min_awake,
                                         headroom=headroom) \
                == RP.provision_awake_set(rcands, demand,
                                          min_awake=min_awake,
                                          headroom=headroom)
        assert P.allocate_demand(cands, demand) \
            == RP.allocate_demand(rcands, demand)
    for c, rc in zip(cands, rcands):
        for tps in (0.0, 1.0, 300.0):
            assert P.amortized_ws_per_token(c.energy_per_token_ws,
                                            c.static_watts, tps) \
                == RP.amortized_ws_per_token(rc.energy_per_token_ws,
                                             rc.static_watts, tps)


def _destinations(mod, fmod, rng, n):
    out = []
    for i in range(n):
        m = fmod.Measurement(time_s=float(rng.integers(1, 9)),
                             energy_ws=float(rng.integers(1, 9)) * 2.0,
                             feasible=bool(rng.integers(0, 5)))
        out.append(mod.Destination(
            name=f"dest{i}", verify_cost_s=float(rng.integers(0, 4)),
            search=(lambda m=m, i=i: (("pattern", i), m))))
    return out


@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=25, deadline=None)
def test_select_destination_bit_identical(seed):
    n = int(np.random.default_rng(seed).integers(0, 6))
    dests = _destinations(DS, F, np.random.default_rng(seed), n)
    rdests = _destinations(RDS, RF, np.random.default_rng(seed), n)
    for req, rreq in zip(_requirements(F), _requirements(RF)):
        got = DS.select_destination(dests, req)
        want = RDS.select_destination(rdests, rreq)
        assert _plain(got) == _plain(want)


# ---------------------------------------------------------------------------
# Fleet search: frontiers, evaluations, cache hits, for two GA seeds
# ---------------------------------------------------------------------------

FLEET = (("llama3.2-3b", "decode_32k"), ("llama3.2-3b", "prefill_32k"),
         ("rwkv6-1.6b", "decode_32k"), ("zamba2-7b", "prefill_32k"),
         ("mixtral-8x7b", "train_4k"), ("seamless-m4t-medium", "decode_32k"))


def _sweep(os_mod, engine_cls, executor_cls, ga_cls, ga_seed, **kw):
    cells = [os_mod.CellSpec.create(arch, shape, mesh, seed=restart)
             for arch, shape in FLEET
             for mesh in PL.DEFAULT_MESH_OPTIONS for restart in (0, 1)]
    eng = engine_cls(executor=executor_cls())
    ga = ga_cls(population=10, generations=8, seed=ga_seed)
    first = os_mod.search_fleet(cells, ga_config=ga, engine=eng,
                                cell_workers=1, **kw)
    again = os_mod.search_fleet(cells, ga_config=ga, engine=eng,
                                cell_workers=1, **kw)
    return first, again


@pytest.mark.parametrize("ga_seed", [0, 7])
def test_search_fleet_bit_identical(ga_seed):
    req = dict(requirement=F.UserRequirement(min_speedup=1.0))
    rreq = dict(requirement=RF.UserRequirement(min_speedup=1.0))
    got = _sweep(OS, EvalEngine, VectorizedExecutor, GAConfig, ga_seed, **req)
    want = _sweep(ROS, RefEvalEngine, RefVectorized, RefGAConfig, ga_seed,
                  **rreq)
    for g, w in zip(got, want):
        assert _plain(g) == _plain(w)
        assert g.evaluations == w.evaluations
        assert g.cache_hits == w.cache_hits
    assert got[0].evaluations > 0 and got[1].evaluations == 0
    assert [cr.cell for cr in got[0].cells] \
        == [cr.spec.key for cr in got[0].cells]
    for cr in got[0].cells:
        assert _plain(got[0].decisions_for(cr.search.frontier[0])) \
            == _plain(want[0].decisions_for(
                next(w for w in want[0].cells if w.cell == cr.cell)
                .search.frontier[0]))


def test_search_lm_cell_bit_identical_and_threaded_fleet_agrees():
    for arch, shape in FLEET[:3]:
        for seed in (0, 2):
            got = OS.search_lm_cell(get_config(arch), SHAPES[shape],
                                    PL.DEFAULT_MESH_OPTIONS[1],
                                    GAConfig(population=8, generations=6),
                                    ga_seed=seed)
            want = ROS.search_lm_cell(ref_get_config(arch),
                                      REF_SHAPES[shape],
                                      PL.DEFAULT_MESH_OPTIONS[1],
                                      RefGAConfig(population=8,
                                                  generations=6),
                                      ga_seed=seed)
            assert _plain(got) == _plain(want)
    cells = [OS.CellSpec.create(a, s, PL.DEFAULT_MESH_OPTIONS[0])
             for a, s in FLEET]
    rcells = [ROS.CellSpec.create(a, s, PL.DEFAULT_MESH_OPTIONS[0])
              for a, s in FLEET]
    threaded = OS.search_fleet(cells, cell_workers=4)
    serial = ROS.search_fleet(rcells, cell_workers=1)
    assert _plain(threaded.frontier) == _plain(serial.frontier)
    assert [_plain(c.search.ga.best) for c in threaded.cells] \
        == [_plain(c.search.ga.best) for c in serial.cells]


def test_search_fleet_refuses_the_screen():
    """The screen came with slice 4b (``analysis/screen.py``): where the
    port refused ``screen=...``, it now screens as the reference does."""
    ga = GAConfig(population=4, generations=3, seed=0)
    rga = RefGAConfig(population=4, generations=3, seed=0)
    cells = [OS.CellSpec.create("llama3.2-3b", "decode_32k",
                                PL.DEFAULT_MESH_OPTIONS[0])]
    rcells = [ROS.CellSpec.create("llama3.2-3b", "decode_32k",
                                  PL.DEFAULT_MESH_OPTIONS[0])]
    got = OS.search_fleet(cells, screen=True, ga_config=ga, cell_workers=1)
    want = ROS.search_fleet(rcells, screen=True, ga_config=rga,
                            cell_workers=1)
    assert got.screen is not None
    assert _plain(got) == _plain(want)
    assert OS.search_fleet(cells, screen=None).screen is None


# ---------------------------------------------------------------------------
# Placements, the controller and serve()
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_static_placements_bit_identical(arch):
    for mesh in PL.DEFAULT_MESH_OPTIONS:
        assert _plain(PL.static_placements(arch, mesh)) \
            == _plain(RPL.static_placements(arch, mesh))
    assert _plain(PL.static_placements(arch, mesh, destination="pod")) \
        == _plain(RPL.static_placements(arch, mesh, destination="pod"))


def test_traffic_helpers_bit_identical():
    for occ in (0.0, 0.1, 0.25, 0.26, 0.5, 0.74, 0.99, 1.0, 1.3):
        assert PL.occupancy_bucket(occ) == RPL.occupancy_bucket(occ)
        for kind in ("prefill", "decode"):
            assert _plain(PL.scale_shape(PL.DEFAULT_CATALOG[kind],
                                         PL.occupancy_bucket(occ))) \
                == _plain(RPL.scale_shape(RPL.DEFAULT_CATALOG[kind],
                                          RPL.occupancy_bucket(occ)))
    live = PL.static_placements("llama3.2-3b", PL.DEFAULT_MESH_OPTIONS[0])
    rlive = RPL.static_placements("llama3.2-3b", PL.DEFAULT_MESH_OPTIONS[0])
    for base, rbase in ((None, None),
                        (F.UserRequirement(max_time_s=4.0),
                         RF.UserRequirement(max_time_s=4.0))):
        for improve in (True, False):
            for slo in (None, 1e-3):
                for kind in (None, "decode"):
                    got = PL.narrowing_requirement(
                        base=base, require_energy_improvement=improve,
                        baseline_energy_ws=12.5,
                        live=live.get(kind) if kind else None,
                        ref_tokens=128, slo_time_per_step_s=slo)
                    want = RPL.narrowing_requirement(
                        base=rbase, require_energy_improvement=improve,
                        baseline_energy_ws=12.5,
                        live=rlive.get(kind) if kind else None,
                        ref_tokens=128, slo_time_per_step_s=slo)
                    assert _plain(got) == _plain(want)


@functools.lru_cache(maxsize=None)
def _models(arch="llama3.2-3b"):
    changes = {"dtype": "float32"}
    rcfg = dataclasses.replace(ref_reduced(ref_get_config(arch)), **changes)
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    model = M.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    "cpu")
    return {RR: (rcfg, params), PR: (cfg, model)}


def _controlled_run(pkg, pl_mod, tmp_path, scheduler):
    cfg, weights = _models()[pkg]
    kw = {"device": "cpu"} if pkg is PR else {}
    eng = pkg.ServingEngine(cfg, weights, slots=4, max_len=48,
                            scheduler=scheduler, **kw)
    eng.reconfigure(pl_mod.static_placements("llama3.2-3b",
                                             pl_mod.DEFAULT_MESH_OPTIONS[0]))
    ga = (GAConfig if pkg is PR else RefGAConfig)(population=6,
                                                  generations=4)
    cache = tmp_path / f"{pkg.__name__}.jsonl"
    ctl = pl_mod.PlacementController(
        eng, "llama3.2-3b", pl_mod.DEFAULT_MESH_OPTIONS,
        cache_path=str(cache), ga_config=ga, interval_steps=4,
        interval_waves=1).attach()
    # prefill-heavy requests first, then decode-heavy ones with an SLO
    reqs = [pkg.Request(rid=i, prompt=[1 + (i + j) % 9 for j in range(12)],
                        max_new_tokens=2) for i in range(6)]
    reqs += [pkg.Request(rid=10 + i, prompt=[2 + i, 3],
                         max_new_tokens=14, slo_s=0.5) for i in range(6)]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    drift = ctl.note_metered("decode",
                             eng.placements["decode"].energy_per_token_ws
                             * 1.5)
    return eng, ctl, done, drift, cache.read_text()


@pytest.mark.parametrize("scheduler", ["stream", "wave"])
def test_controller_plans_and_ledger_bit_identical(scheduler, tmp_path):
    eng, ctl, done, drift, cache = _controlled_run(PR, PL, tmp_path,
                                                   scheduler)
    reng, rctl, rdone, rdrift, rcache = _controlled_run(RR, RPL, tmp_path,
                                                        scheduler)
    assert [(r.rid, r.output, r.finish_reason) for r in done] \
        == [(r.rid, r.output, r.finish_reason) for r in rdone]
    assert len(ctl.history) == len(rctl.history) >= 2
    assert _plain(ctl.history) == _plain(rctl.history)
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(reng.stats)
    assert eng.stats.energy_ws > 0.0
    assert _plain(eng.placements) == _plain(reng.placements)
    assert sum(r.new_measurements for r in ctl.history) > 0
    assert (drift, ctl.drift, eng.energy_correction) \
        == (rdrift, rctl.drift, reng.energy_correction)
    assert drift is True and ctl._resweep_pending
    assert cache == rcache  # the persisted measurement cache, byte for byte
    assert [(r.served_by, r.destination) for r in done] \
        == [(r.served_by, r.destination) for r in rdone]


def _ref_weights(monkeypatch, arch):
    """The port's serve() on the reference's weights for ``arch``'s
    reduced config."""
    rcfg = ref_reduced(ref_get_config(arch))
    params = jax.tree.map(np.asarray,
                          RM.init_params(rcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(serve_mod, "M", types.SimpleNamespace(
        init_params=lambda cfg, generator: M.params_from_reference(
            cfg, params, generator.device)))


@pytest.mark.parametrize("adaptive", [False, True])
def test_serve_matches_reference(adaptive, tmp_path, monkeypatch):
    _ref_weights(monkeypatch, "llama3.2-3b")
    kw = dict(num_requests=8, slots=4, max_new_tokens=8, adaptive=adaptive)
    got = serve_mod.serve("llama3.2-3b", device="cpu",
                          cache_path=str(tmp_path / "port.jsonl"), **kw)
    want = ref_serve_mod.serve("llama3.2-3b",
                               cache_path=str(tmp_path / "ref.jsonl"), **kw)
    timed = {"wall_s", "tokens_per_s"}
    assert set(got) - set(want) == {"total_tokens", "device"}
    assert {k: v for k, v in got.items() if k in want and k not in timed} \
        == {k: v for k, v in want.items() if k not in timed}
    assert got["energy_ws"] > 0.0
    if adaptive:
        assert got["new_measurements"] > 0
        assert (tmp_path / "port.jsonl").read_text() \
            == (tmp_path / "ref.jsonl").read_text()
