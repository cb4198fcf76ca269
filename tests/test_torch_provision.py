"""The port's capacity planner, static pre-screen, power-model calibration,
narrowing, reconfiguration, fault tolerance and metered fleet-cell backend
against the JAX package's, on the CPU.

All of these are pure Python (calibration numpy) over the analytic cost
model in both packages, so every result must be equal: budgets, destination
economics from a real GA sweep (with their persisted caches byte for byte),
fleet plans and cost-of-capacity frontiers, screen reports and screened
fleet sweeps, fitted power models, narrowing reports and the metered
backend's measurements, every float compared with ``==`` and wall-clock
fields (``wall_s``) left out.
"""
import importlib
import types

import pytest

from _hypothesis_compat import given, settings, st
from _parity import plain

PKG_MODULES = {
    "provision": "provision",
    "forecast": "workload.forecast",
    "workload": "workload",
    "destinations": "configs.destinations",
    "configs": "configs",
    "pareto": "core.pareto",
    "power": "core.power",
    "screen": "analysis.screen",
    "analysis": "analysis",
    "search": "core.offload_search",
    "evaluator": "core.evaluator",
    "ga": "core.ga",
    "fitness": "core.fitness",
    "ai": "core.arithmetic_intensity",
    "lm": "core.lm_cost_model",
    "candidates": "core.candidates",
    "reconfigure": "core.reconfigure",
    "ft": "runtime.fault_tolerance",
    "runtime": "runtime",
    "telemetry": "telemetry",
    "placement": "runtime.placement",
}


def _pkg(root):
    return types.SimpleNamespace(name=root, **{
        k: importlib.import_module(f"{root}.{m}")
        for k, m in PKG_MODULES.items()})


REF, PORT = _pkg("repro"), _pkg("repro_torch")
PKGS = (REF, PORT)
MESH = {"data": 16, "model": 16}


def _both(fn, *args):
    """``fn(pkg, *args)`` through both packages; the port's result, after
    asserting that it equals the reference's."""
    want = fn(REF, *args)
    got = fn(PORT, *args)
    assert plain(got) == plain(want)
    return got


def test_package_surfaces_match():
    for key in ("provision", "workload", "analysis", "runtime", "telemetry",
                "configs"):
        ref, port = getattr(REF, key), getattr(PORT, key)
        if key == "analysis":
            # a counterpart of every name the reference's analysis package
            # imports, renamed where the name is a JAX or Pallas object's
            renamed = {"walk_graph": "walk_closed",
                       "lint_graph_hazards": "lint_jaxpr_hazards",
                       "CapturedLaunch": "CapturedCall",
                       "capture_launches": "capture_pallas_calls"}
            assert set(port.__all__) == {
                "CellStatics", "ScreenPolicy", "ScreenReport", "screen_cells",
                "ConcurrencyReport", "Finding", "SharedAttr", "lint_runtime",
                "lint_scan", "scan_paths", "scan_source", "EqnStats",
                "RegionReport", "classify_primitive", "trace_and_walk",
                "walk_graph", "lint_decode_family", "lint_graph_hazards",
                "lint_model_families", "CapturedLaunch", "capture_launches",
                "lint_captured", "lint_kernel_families"}
            public = {n for n in vars(ref) if not n.startswith("_")
                      and not isinstance(getattr(ref, n), types.ModuleType)}
            assert {renamed.get(n, n) for n in port.__all__} == public
            continue
        missing = set(ref.__all__) - set(port.__all__)
        assert not missing, (key, missing)
    from repro import core as ref_core
    from repro_torch import core
    assert set(ref_core.__all__) <= set(core.__all__)


# ---------------------------------------------------------------------------
# Budget, economics, the fleet planner
# ---------------------------------------------------------------------------


def _synthetic(pkg):
    def spec(name, axes=2, p_idle=10.0, **kw):
        return pkg.destinations.DestinationSpec(
            name=name, mesh=(("data", axes),),
            power=pkg.power.TpuPowerModel(p_idle=p_idle), verify_cost_s=0.0,
            **kw)

    def econ(s, order, prefill, decode, slots=2):
        return pkg.provision.DestinationEconomics(
            spec=s, order=order, slots=slots,
            rates=(pkg.provision.KindRate("prefill", *prefill),
                   pkg.provision.KindRate("decode", *decode)))

    big = econ(spec("big", axes=8, p_idle=20.0), 0, (0.5, 1e-5), (0.8, 4e-5))
    eff = econ(spec("eff", axes=4, p_idle=10.0), 1, (0.3, 2e-5), (0.5, 8e-5))
    lp = econ(spec("lp", axes=1, p_idle=2.0), 2, (0.2, 8e-5), (0.25, 2e-4))
    F = pkg.forecast
    fc = F.WorkloadForecast(
        duration_s=10.0, requests=200, total_tokens=400_000,
        mean_tps=40_000.0, peak_tps=90_000.0, prefill_frac=0.6,
        tenants=(F.TenantForecast("chat", 120, 32, 16, 0.05),
                 F.TenantForecast("batch", 80, 128, 64, None)),
        trace_digest="synthetic")
    return [big, eff, lp], fc


def _budgets(pkg):
    B = pkg.provision.Budget
    out = []
    for kw in ({"watts": 0.0}, {"watts": 100.0, "area": -1.0},
               {"watts": 100.0, "count_caps": (("a", -1),)},
               {"watts": 100.0, "count_caps": (("a", 1), ("a", 2))}):
        with pytest.raises(ValueError):
            B(**kw)
    b = B.create(100.0, area=10.0, count_caps={"eff": 2})
    out += [b, b.admits(100.0, 10.0), b.admits(100.1, 1.0),
            b.admits(1.0, 10.1), B.create(100.0).admits(99.0, 1e9),
            b.cap("eff", 10), b.cap("other", 10)]
    return out


def test_budget_matches_reference():
    got = _both(_budgets)
    assert got[1:] == [True, False, False, True, 2, 10]


def _evaluations(pkg):
    econ, fc = _synthetic(pkg)
    names = [e.name for e in econ]
    out = []
    for counts in ({"big": 1, "lp": 2}, {"lp": 1}, {"big": 9}, {"big": 4},
                   {"eff": 2, "lp": 3}):
        for budget in (pkg.provision.Budget.create(1e9),
                       pkg.provision.Budget.create(1.0)):
            g = pkg.provision.FleetGenome.create(counts, names)
            ev = pkg.provision.evaluate_fleet(g, econ, budget, fc)
            out.append((ev, ev.feasible, ev.sort_key(), ev.to_json()))
    alloc = pkg.pareto.allocate_demand(
        [pkg.pareto.CapacityPoint("a", 1.0, 10.0, 100.0, order=0),
         pkg.pareto.CapacityPoint("b", 0.9, 1000.0, 100.0, order=1)], 150.0)
    return out, alloc, [(e.capacity_tps, e.mix_energy_per_token_ws(0.6),
                         e.request_latency_s(32, 16), e.to_json())
                        for e in econ]


def test_evaluate_fleet_matches_reference():
    _both(_evaluations)


def _plans(pkg, watts):
    econ, fc = _synthetic(pkg)
    P = pkg.provision
    budget = P.Budget.create(watts)
    exact = P.plan_fleet(econ, budget, fc,
                         policy=P.SearchPolicy(max_enumeration=10**6))
    beam = P.plan_fleet(econ, budget, fc,
                        policy=P.SearchPolicy(max_enumeration=1,
                                              beam_width=16))
    capped = P.plan_fleet(
        econ, P.Budget.create(watts, area=12.0, count_caps={"big": 0}), fc,
        policy=P.SearchPolicy(max_count_per_type=8))
    frontier = P.cost_of_capacity_frontier(
        econ, (watts / 4, watts / 2, watts, watts * 2), fc)
    catalog = {e.name: e.spec for e in econ}
    return (exact.to_json(), beam.to_json(), capped.to_json(),
            [p.to_json() for p in frontier], exact.counts,
            [d.name for d in exact.destinations(catalog)]
            if exact.best else None)


@given(watts=st.floats(50.0, 2000.0))
@settings(max_examples=8, deadline=None)
def test_plan_fleet_and_frontier_match_reference(watts):
    got = _both(_plans, watts)
    assert got[0]["best"] is None or got[0]["best"]["provisioned_watts"] \
        <= watts


def _economics(pkg, tmp_path):
    specs = [pkg.destinations.DESTINATIONS[n]
             for n in ("mxu_dense", "hbm_lp")]
    ga = pkg.ga.GAConfig(population=6, generations=3, seed=0)
    cache = str(tmp_path / f"{pkg.name}.jsonl")
    runs = [pkg.provision.destination_economics(
        "llama3.2-3b", specs, shapes=pkg.placement.DEFAULT_CATALOG, slots=2,
        cache_path=cache, ga_config=ga, **kw)
        for kw in ({}, {}, {"screen": False})]
    assert runs[0].new_measurements > 0 and runs[1].new_measurements == 0
    return ([(r.new_measurements, [e.to_json() for e in r.economics],
              r.skipped) for r in runs], open(cache).read())


def test_destination_economics_matches_reference(tmp_path):
    _both(_economics, tmp_path)


def _provision_counts(pkg, tmp_path):
    serve = importlib.import_module(f"{pkg.name}.launch.serve")
    return {w: serve._provision_counts("llama3.2-3b", w,
                                       str(tmp_path / f"{pkg.name}.jsonl"))
            for w in (30_000.0, 50_000.0, 100_000.0)}


def test_serve_provision_counts_match_reference(tmp_path):
    got = _both(_provision_counts, tmp_path)
    assert got[50_000.0] == {"mxu_dense": 1, "hbm_lp": 1}


def _router_provisioned(pkg):
    cls = pkg.runtime.FleetRouter
    for counts, match in (({"nope": 1}, "unknown"), ({"hbm_lp": 0}, "empty")):
        with pytest.raises(ValueError, match=match):
            cls.provisioned(None, None, counts, arch="llama3.2-3b",
                            cache_path=None)
    return True


def test_router_provisioned_refusals_match_reference():
    _both(_router_provisioned)


# ---------------------------------------------------------------------------
# The static pre-screen and search_fleet(screen=...)
# ---------------------------------------------------------------------------


def _fleet_cells(pkg):
    S = pkg.search
    hot = pkg.power.TpuPowerModel(p_idle=95.0, p_mxu=130.0, p_hbm=45.0,
                                  p_ici=14.0)
    return [
        S.CellSpec.create("llama3.2-3b", "decode_32k", MESH),
        S.CellSpec.create("rwkv6-1.6b", "decode_32k", MESH),
        S.CellSpec.create("llama3.2-3b", "decode_32k", MESH, power=hot),
        S.CellSpec.create("qwen1.5-110b", "train_4k",
                          {"data": 2, "model": 2}),
        S.CellSpec.create("llama3.2-3b", "decode_32k", MESH, seed=1),
        S.CellSpec.create("llama3.2-3b", "decode_32k", MESH, backend="nope"),
        S.CellSpec.create("mixtral-8x7b", "prefill_32k", MESH),
        S.CellSpec.create("zamba2-7b", "decode_32k", {"data": 4, "model": 4}),
    ]


def _screens(pkg):
    cells = _fleet_cells(pkg)
    P = pkg.screen.ScreenPolicy
    reports = [pkg.screen.screen_cells(cells[:4]),
               pkg.screen.screen_cells(cells),
               pkg.screen.screen_cells(cells, policy=P(infeasible=False,
                                                      dominance=False))]
    statics = [pkg.screen.cell_statics(c, pkg.power.TpuPowerModel(), P())
               for c in cells[:4] + cells[6:]]
    return ([(r, r.cells_in, r.to_json()) for r in reports], statics,
            [s.all_infeasible for s in statics])


def test_screen_cells_match_reference():
    reports, _, _ = _both(_screens)
    first = reports[0][0]
    assert {d.key: d.reason for d in first.dropped} \
        == {"qwen1.5-110b/train_4k/data2xmodel2": "infeasible",
            next(d.key for d in first.dropped if "@pw:" in d.key):
                "intensity-floor"}
    assert reports[2][0].dropped == []


def _screened_sweep(pkg, screen):
    cells = _fleet_cells(pkg)[:4] + _fleet_cells(pkg)[6:]
    ga = pkg.ga.GAConfig(population=4, generations=4, seed=0)
    eng = pkg.evaluator.EvalEngine(executor=pkg.evaluator.VectorizedExecutor())
    if screen == "policy":
        screen = pkg.screen.ScreenPolicy(dominance=False)
    res = pkg.search.search_fleet(cells, ga_config=ga, engine=eng,
                                  screen=screen, cell_workers=1)
    return res, res.evaluations, list(eng.screened_cells)


@pytest.mark.parametrize("screen", [None, True, "policy"])
def test_search_fleet_screen_matches_reference(screen):
    res, evaluations, screened = _both(_screened_sweep, screen)
    if screen:
        assert res.screen is not None and screened
        unscreened = _screened_sweep(PORT, None)[0]
        assert evaluations < unscreened.evaluations
        assert [(p.cell, p.genome, p.time_s, p.energy_ws)
                for p in res.frontier] \
            == [(p.cell, p.genome, p.time_s, p.energy_ws)
                for p in unscreened.frontier]
    else:
        assert res.screen is None and not screened


# ---------------------------------------------------------------------------
# Calibration and the calibrated catalog
# ---------------------------------------------------------------------------


def _fits(pkg):
    T, pw = pkg.telemetry, pkg.power
    pm = pw.PaperPowerModel()
    paper = [T.PaperSample(t, d, pm.energy(t, d))
             for t, d in ((153.0, 0.0), (19.0, 19.0), (40.0, 13.3),
                          (60.0, 30.0))]
    true = pw.TpuPowerModel(p_idle=55.0, p_mxu=140.0, p_hbm=28.0, p_ici=14.0)
    tpu = []
    for tc, tm, ti, clk in ((0.8, 0.3, 0.1, 1.0), (0.2, 0.9, 0.0, 1.0),
                            (0.5, 0.5, 0.4, 1.0), (0.9, 0.1, 0.2, 0.7),
                            (0.6, 0.7, 0.3, 0.85), (1.0, 0.2, 0.0, 0.7)):
        t = max(tc, tm, ti)
        scaled = pw.TpuPowerModel(p_idle=true.p_idle,
                                  p_mxu=true.p_mxu * clk ** 3,
                                  p_hbm=true.p_hbm, p_ici=true.p_ici)
        tpu.append(T.TpuSample(4, t, tc, tm, ti,
                               scaled.energy(4, t, tc, tm, ti), clock=clk))
    for fn, few in ((T.fit_paper_model, paper[:1]),
                    (T.fit_tpu_model, tpu[:3])):
        with pytest.raises(ValueError):
            fn(few)
    rep = T.error_report([("a", 110.0, 100.0), ("b", 95.0, 100.0),
                          ("c", 100.0, 100.0)])
    cfg = pkg.configs.get_config("llama3.2-3b")
    m = pkg.lm.measure_cell(cfg, pkg.configs.SHAPES["prefill_32k"], MESH,
                            pkg.lm.Decisions())
    return (T.fit_paper_model(paper), T.fit_tpu_model(tpu), rep,
            rep.max_abs_rel_error, rep.mean_abs_rel_error, rep.rmse_ws,
            rep.worst(), rep.to_json(), T.error_report([]).worst(),
            T.TpuSample.from_measurement(m),
            T.TpuSample.from_measurement(m, clock=0.7))


def test_calibration_fits_match_reference():
    fits = _both(_fits)
    assert fits[0].p_cpu == pytest.approx(27.0, rel=1e-6)
    assert fits[1].p_mxu == pytest.approx(140.0, rel=1e-6)


def _catalogs(pkg, tmp_path):
    T, D = pkg.telemetry, pkg.destinations
    path = str(tmp_path / f"{pkg.name}_fits.json")
    fitted = pkg.power.TpuPowerModel(p_idle=55.0, p_mxu=111.0, p_hbm=22.0,
                                     p_ici=3.0)
    missing = D.calibrated_catalog(fits_path=str(tmp_path / "nope.json"))
    T.save_tpu_fits(path, {"mxu_dense": fitted,
                           "not_in_catalog": pkg.power.TpuPowerModel()})
    overlay = D.calibrated_catalog(fits_path=path)
    bad = str(tmp_path / f"{pkg.name}_bad.json")
    T.save_tpu_fits(bad, {"hbm_lp": pkg.power.TpuPowerModel(p_idle=-5.0)})
    with pytest.raises(ValueError, match="p_idle"):
        D.calibrated_catalog(fits_path=bad)
    return (missing, overlay, T.load_tpu_fits(path), open(path).read(),
            D.DEFAULT_FITS_PATH, D.mixed_fleet(),
            D.mixed_fleet(("hbm_lp", "pod_v5e")),
            [(s.chips, s.idle_watts, s.peak_watts, s.area)
             for s in D.DESTINATIONS.values()])


def test_calibrated_catalog_matches_reference(tmp_path):
    got = _both(_catalogs, tmp_path)
    assert got[1]["mxu_dense"].power.p_mxu == 111.0


def _spec_refusals(pkg):
    D, pw = pkg.destinations, pkg.power

    def spec(**kw):
        kw.setdefault("mesh", (("data", 2),))
        kw.setdefault("power", pw.TpuPowerModel())
        return D.DestinationSpec(name="x", verify_cost_s=0.0, **kw)

    for kw, match in (({"power": pw.TpuPowerModel(p_idle=-1.0)}, "p_idle"),
                      ({"floor_frac": 1.5}, "floor_frac"),
                      ({"sleep_frac": -0.1}, "sleep_frac"),
                      ({"wake_s": 0.1, "floor_wake_s": 0.2}, "floor_wake_s"),
                      ({"area": -1.0}, "area"), ({"mesh": ()}, "mesh")):
        with pytest.raises(ValueError, match=match):
            spec(**kw)
    return spec(area=7.5), spec()


def test_destination_spec_validation_matches_reference():
    _both(_spec_refusals)


# ---------------------------------------------------------------------------
# Narrowing, reconfiguration, fault tolerance
# ---------------------------------------------------------------------------


def _narrowing(pkg):
    units = pkg.ai.himeno_unit_costs((64, 64, 128), iters=8)

    def measure(pattern):
        t = 100.0
        for name in pattern:
            t -= 60.0 if name == "jacobi_stencil" else 1.0
        return pkg.fitness.Measurement(time_s=max(t, 1.0),
                                       energy_ws=27.0 * max(t, 1.0))

    C = pkg.candidates
    return [C.narrow_and_measure(units, measure, cfg) for cfg in (
        C.NarrowingConfig(intensity_keep=3, tripcount_keep=3,
                          max_measured=4),
        C.NarrowingConfig(resource_limit=1.0), C.NarrowingConfig())]


def test_narrow_and_measure_matches_reference():
    reports = _both(_narrowing)
    assert "jacobi_stencil" in reports[0].best_pattern
    assert "jacobi_stencil" not in reports[1].after_resource


def _reconfigure(pkg):
    R = pkg.reconfigure
    sla = pkg.fitness.UserRequirement(max_time_s=1.0)
    pol = R.ReconfigurePolicy(sla_violation_patience=2)
    states = [R.ClusterState(healthy_chips=256, total_chips=256,
                             step_time_s=2.0, sla=sla)] * 2 + [
        R.ClusterState(healthy_chips=240, total_chips=256, step_time_s=1.0),
        R.ClusterState(healthy_chips=8, total_chips=256, step_time_s=1.0),
        R.ClusterState(healthy_chips=256, total_chips=256, step_time_s=0.5,
                       sla=sla)]
    return ([pol.decide(s) for s in states],
            [pol.largest_valid_slice(c) for c in (0, 15, 16, 240, 256)])


def test_reconfigure_policy_matches_reference():
    actions, _ = _both(_reconfigure)
    assert [a.kind for a in actions[:2]] == ["continue", "research"]


def _fault_tolerance(pkg):
    ft = pkg.ft
    mon = ft.HeartbeatMonitor(num_nodes=4, interval_s=10, grace_intervals=3)
    for n in range(4):
        mon.beat(n, now=0.0)
    sweeps = [mon.sweep(now=29.0)]
    for n in range(3):
        mon.beat(n, now=29.0)
    sweeps.append(mon.sweep(now=31.0))
    det = ft.StragglerDetector(window=8, threshold=1.5, patience=2)
    flagged = []
    for _ in range(6):
        for shard in range(4):
            det.record(shard, 1.0 if shard != 2 else 2.5)
        flagged.append(det.stragglers())
    orch = ft.ElasticOrchestrator(total_chips=256, chips_per_node=8,
                                  model_parallel=16)
    big = ft.HeartbeatMonitor(num_nodes=32)
    for n in range(32):
        big.beat(n, 0.0)
    for n in (30, 31):
        big.nodes[n].healthy = False
    action = orch.plan(big, step_time_s=1.0)
    return (sweeps, mon.healthy_count(), flagged, det.backup_deadline(),
            action, orch.degraded_mesh_shape(action.target_chips))


def test_fault_tolerance_matches_reference():
    sweeps, healthy, flagged, _, action, mesh = _both(_fault_tolerance)
    assert sweeps == [[], [3]] and healthy == 3 and flagged[-1] == [2]
    assert (action.kind, action.target_chips, mesh) \
        == ("rescale", 128, {"data": 8, "model": 16})


# ---------------------------------------------------------------------------
# The metered fleet-cell backend
# ---------------------------------------------------------------------------


def _metered(pkg):
    T, lm, pw = pkg.telemetry, pkg.lm, pkg.power
    cfg = pkg.configs.get_config("llama3.2-3b")
    shape = pkg.configs.SHAPES["prefill_32k"]
    nominal = T.metered_lm_backend(cfg, shape, MESH)
    hot = T.metered_lm_backend(cfg, shape, MESH, true_power=pw.TpuPowerModel(
        p_idle=90.0, p_mxu=160.0, p_hbm=50.0, p_ici=20.0))
    out = []
    for dec in (lm.Decisions(), lm.Decisions(clock=0.7),
                lm.Decisions(overlap=False)):
        m = nominal(dec)
        modeled = lm.measure_cell(cfg, shape, MESH, dec)
        assert m.time_s == pytest.approx(modeled.time_s)
        assert abs(m.detail["metered"]["model_error"]) < 0.02
        out.append((m, modeled))
    gap = hot(lm.Decisions())
    assert gap.detail["metered"]["model_error"] > 0.05
    rep = T.report_from_metered([("cell", gap)])
    infeasible = T.metered_lm_backend(
        pkg.configs.get_config("qwen1.5-110b"), pkg.configs.SHAPES["train_4k"],
        {"data": 2, "model": 2})(lm.Decisions())
    assert pkg.evaluator.get_backend("metered") is T.metered_lm_backend
    cells = [pkg.search.CellSpec.create("llama3.2-3b", "decode_32k", MESH,
                                        backend=b)
             for b in (None, "metered")]
    fleet = pkg.search.search_fleet(
        cells, ga_config=pkg.ga.GAConfig(population=4, generations=3,
                                         seed=0), cell_workers=1)
    return out, gap, rep, infeasible, fleet


def test_metered_lm_backend_matches_reference():
    _both(_metered)
