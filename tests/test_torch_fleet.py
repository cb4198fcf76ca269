"""The port's fleet (router, lockstep executor, router-bound migration and
``serve_fleet``) against the JAX package's, on the CPU.

Every scenario of the reference's ``tests/test_router.py``, the executor
cases of ``tests/test_concurrency.py`` and the router-bound cases of
``tests/test_migration.py`` runs through both packages on the same inputs
and the same weights: the reduced llama3.2-3b (and, for the executor,
rwkv6-1.6b and zamba2-7b) in float32, drawn by the reference's
``init_params`` and carried across with ``params_from_reference``, with
measurement caches under ``tmp_path``. The fleet layer is pure Python in
both packages, so each scenario's record must be equal: tokens, routing,
``served_by``, ledgers, plans, power states and migrations, every float
compared with ``==`` and wall-clock fields (``wall_s``) left out.
``serve_fleet``'s report is compared on its own reduced config (bfloat16),
as ``tests/test_torch_placement.py`` compares ``serve()``'s, with the
port's ``init_params`` replaced by the reference's weights.

Also here: the kernel wrappers' launch counter, exact under threads.
"""
import dataclasses
import functools
import random
import threading
import types

import jax
import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from _parity import plain
from repro import models as RM
from repro import runtime as RR
from repro.configs import DESTINATIONS as REF_DESTINATIONS
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.core import pareto as RP
from repro.core.fitness import Measurement as RefMeasurement
from repro.core.ga import GAConfig as RefGAConfig
from repro.launch import serve as ref_serve_mod
from repro.runtime import migration as ref_migration
from repro_torch import models as M
from repro_torch import runtime as PR
from repro_torch.configs import DESTINATIONS, get_config, reduced
from repro_torch.core import pareto as P
from repro_torch.core.fitness import Measurement
from repro_torch.core.ga import GAConfig
from repro_torch.kernels._build import count_launch, reset_counts
from repro_torch.launch import serve as serve_mod
from repro_torch.runtime import migration

REF = types.SimpleNamespace(
    name="ref", rt=RR, DESTINATIONS=REF_DESTINATIONS, pareto=RP,
    Measurement=RefMeasurement, GAConfig=RefGAConfig,
    migration=ref_migration, dev={})
PORT = types.SimpleNamespace(
    name="port", rt=PR, DESTINATIONS=DESTINATIONS, pareto=P,
    Measurement=Measurement, GAConfig=GAConfig, migration=migration,
    dev={"device": "cpu"})
PKGS = (REF, PORT)
MIXED = ("pod2_v5e", "mxu_dense", "hbm_lp")
FAMILIES = {"dense": "llama3.2-3b", "ssm": "rwkv6-1.6b",
            "hybrid": "zamba2-7b"}


@functools.lru_cache(maxsize=None)
def _models(arch="llama3.2-3b"):
    changes = {"dtype": "float32"}
    rcfg = dataclasses.replace(ref_reduced(ref_get_config(arch)), **changes)
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    model = M.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    "cpu")
    return {"ref": (rcfg, params), "port": (cfg, model)}


def _router(pkg, tmp_path, *, dests=MIXED, arch="llama3.2-3b",
            cache=True, **kw):
    """The reference tests' router: energy policy, 2 slots, max_len 32, a
    small GA, and a measurement cache of the package's own."""
    kw.setdefault("policy", "energy")
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("ga_config", pkg.GAConfig(population=8, generations=6,
                                            seed=0))
    cfg, weights = _models(arch)[pkg.name]
    specs = [d if not isinstance(d, str) else pkg.DESTINATIONS[d]
             for d in dests]
    path = str(tmp_path / pkg.name / "cache.jsonl") if cache else None
    return pkg.rt.FleetRouter(cfg, weights, specs, arch="llama3.2-3b",
                              cache_path=path, **kw, **pkg.dev)


def prefill_heavy(pkg, rid, slo=None):
    return pkg.rt.Request(rid=rid, prompt=[1 + (rid + j) % 17
                                           for j in range(20)],
                          max_new_tokens=2, slo_s=slo)


def decode_heavy(pkg, rid, slo=None):
    return pkg.rt.Request(rid=rid, prompt=[1 + rid % 7, 3],
                          max_new_tokens=10, slo_s=slo)


def mixed_requests(pkg, n=8, base=0):
    return [prefill_heavy(pkg, base + i) if i % 2 == 0
            else decode_heavy(pkg, base + i) for i in range(n)]


def _outputs(done):
    return [(r.rid, tuple(r.output), r.finish_reason, r.served_by,
             r.destination) for r in done]


def _fleet(router):
    """The router's whole observable state after a run."""
    return {"fleet": router.fleet_stats(),
            "engines": router.per_engine_stats(),
            "assignments": dict(router.assignments),
            "rejected": [r.rid for r in router.rejected],
            "history": router.history,
            "power": router.power_states(),
            "placements": {b.name: b.engine.placements
                           for b in router.bindings}}


# ---------------------------------------------------------------------------
# The reference's tests/test_router.py, scenario by scenario
# ---------------------------------------------------------------------------


def _round_robin(pkg, tmp_path):
    router = _router(pkg, tmp_path, policy="round_robin")
    for r in mixed_requests(pkg, 6):
        router.submit(r)
    got = [router.assignments[i] for i in range(6)]
    assert got == list(MIXED) * 2
    return got


def _energy_split(pkg, tmp_path):
    router = _router(pkg, tmp_path)
    costs = {b.name: router.marginal_energy_ws(b.engine,
                                               decode_heavy(pkg, 2))
             for b in router.bindings}
    got = (router.route(prefill_heavy(pkg, 0)),
           router.route(decode_heavy(pkg, 1)), costs)
    assert got[:2] == ("mxu_dense", "hbm_lp")
    assert min(costs, key=costs.get) == "hbm_lp"
    return got


def _deterministic(pkg, tmp_path):
    out = {}
    for policy in ("energy", "latency", "round_robin"):
        a = _router(pkg, tmp_path / f"a_{policy}", policy=policy)
        b = _router(pkg, tmp_path / f"b_{policy}", policy=policy)
        for r1, r2 in zip(mixed_requests(pkg, 8), mixed_requests(pkg, 8)):
            a.submit(r1)
            b.submit(r2)
        assert a.assignments == b.assignments
        out[policy] = dict(a.assignments)
    return out


def _slo(pkg, tmp_path):
    router = _router(pkg, tmp_path)
    loose = router.route(decode_heavy(pkg, 0, slo=1e-2))
    tight = decode_heavy(pkg, 1, slo=2e-4)
    chosen = router.route(tight)
    router.submit(tight)
    assert (loose, chosen) == ("hbm_lp", "pod2_v5e")
    assert router.engines["pod2_v5e"].queue
    etas = {b.name: router.eta_s(b, tight) for b in router.bindings}
    return loose, chosen, etas


def _refusals(pkg, tmp_path):
    for kw in ({"policy": "nope"}, {"dests": ()}):
        with pytest.raises(ValueError):
            _router(pkg, tmp_path, **kw)
    return True


def _homogeneous(pkg, tmp_path):
    router = _router(pkg, tmp_path, dests=("pod2_v5e",) * 3,
                     policy="round_robin")
    got = ([b.name for b in router.bindings],
           [d.name for d in router.destinations])
    assert got == (["pod2_v5e:0", "pod2_v5e:1", "pod2_v5e:2"],
                   ["pod2_v5e"])
    return got


def _ledger(pkg, tmp_path):
    router = _router(pkg, tmp_path)
    reqs = mixed_requests(pkg, 8)
    for r in reqs:
        router.submit(r)
    done = router.run()
    fleet = router.fleet_stats()
    for f in pkg.rt.EngineStats.__dataclass_fields__:
        assert getattr(fleet, f) == sum(
            getattr(s, f) for s in router.per_engine_stats().values()), f
    assert fleet.prefill_tokens == sum(len(r.prompt) for r in reqs)
    assert len(done) == len(reqs) and fleet.energy_ws > 0
    return _outputs(done), _fleet(router)


def _attribution(pkg, tmp_path):
    router = _router(pkg, tmp_path)
    for r in mixed_requests(pkg, 4):
        router.submit(r)
    done = router.run()
    for r in done:
        assert r.served_by == router.assignments[r.rid] == r.destination
    return _outputs(done)


def _drain(pkg, tmp_path):
    router = _router(pkg, tmp_path, policy="round_robin")
    reqs = mixed_requests(pkg, 9)
    for r in reqs:
        router.submit(r)
    moved = router.rebalance(dominated=["pod2_v5e"])
    assert moved == {"pod2_v5e": 3}
    done = router.run()
    fleet = router.fleet_stats()
    assert fleet.admissions == fleet.completed == len(reqs)
    for r in done:
        assert r.served_by != "pod2_v5e"
        assert router.assignments[r.rid] == r.served_by
    return moved, _outputs(done), _fleet(router)


def _whole_fleet(pkg, tmp_path):
    router = _router(pkg, tmp_path, policy="round_robin")
    for r in mixed_requests(pkg, 3):
        router.submit(r)
    got = router.rebalance(dominated=list(MIXED))
    assert got == {}
    return got, [len(e.queue) for e in router.engines.values()]


def _twins(pkg, tmp_path):
    pod2 = pkg.DESTINATIONS["pod2_v5e"]
    twin = type(pod2)(name="pod2_twin", mesh=pod2.mesh, power=pod2.power,
                      verify_cost_s=pod2.verify_cost_s)
    router = _router(pkg, tmp_path, policy="round_robin",
                     dests=(pod2, twin, "hbm_lp"))
    for r in mixed_requests(pkg, 8):
        router.submit(r)
    done = router.run()
    report = router.plan()
    assert not {"pod2_v5e", "pod2_twin"} & set(report.dominated)
    return _outputs(done), report


def _dominated(pkg, tmp_path):
    router = _router(pkg, tmp_path, dests=("pod_v5e",) + MIXED,
                     policy="round_robin")
    for r in mixed_requests(pkg, 8):
        router.submit(r)
    router.run()
    report = router.plan()
    assert report.dominated == ["pod_v5e"]
    for r in mixed_requests(pkg, 8, base=100):
        router.submit(r)
    queued = len(router.engines["pod_v5e"].queue)
    moved = router.rebalance()
    assert moved == {"pod_v5e": queued} and queued > 0
    return report, moved, _fleet(router)


def _engines_alone(pkg, tmp_path):
    router = _router(pkg, tmp_path)
    for r in mixed_requests(pkg, 8):
        router.submit(r)
    fleet_done = {r.rid: list(r.output) for r in router.run()}
    cfg, weights = _models()[pkg.name]
    solo_done = {}
    for name in router.engines:
        solo = pkg.rt.ServingEngine(cfg, weights, slots=2, max_len=32,
                                    **pkg.dev)
        for r in mixed_requests(pkg, 8):
            if router.assignments[r.rid] == name:
                solo.submit(r)
        solo_done.update({r.rid: list(r.output) for r in solo.run()})
    assert solo_done == fleet_done
    return fleet_done


def _shared_sweep(pkg, tmp_path):
    router = _router(pkg, tmp_path)
    for r in mixed_requests(pkg, 8):
        router.submit(r)
    router.run()
    report = router.plan()
    assert report.new_measurements > 0
    assert set(report.placements) == set(MIXED)
    for name, by_kind in report.placements.items():
        for kind, p in by_kind.items():
            assert (p.source, p.destination, p.kind) \
                == ("adaptive", name, kind)
    assert set(report.preferred) == {"prefill", "decode"}
    return report, _fleet(router)


def _replan(pkg, tmp_path):
    reports = []
    for _ in range(2):
        router = _router(pkg, tmp_path)
        for r in mixed_requests(pkg, 8):
            router.submit(r)
        router.run()
        reports.append(router.plan())
    assert reports[0].new_measurements > 0
    assert reports[1].new_measurements == 0
    cache = (tmp_path / pkg.name / "cache.jsonl").read_text()
    return reports, cache


def _no_worse(pkg, tmp_path):
    router = _router(pkg, tmp_path)
    static = {b.name: {k: p.energy_per_token_ws
                       for k, p in b.engine.placements.items()}
              for b in router.bindings}
    for r in mixed_requests(pkg, 8):
        router.submit(r)
    router.run()
    report = router.plan()
    for name, by_kind in report.placements.items():
        for kind, p in by_kind.items():
            assert p.energy_per_token_ws <= static[name][kind] * (1 + 1e-9)
    return static, report


def _pareto_queries(pkg, tmp_path):
    def pt(cell, t, e):
        return pkg.pareto.ParetoPoint(
            genome=(0,), cell=cell,
            measurement=pkg.Measurement(time_s=t, energy_ws=e))

    dest = {"a": "gpu", "b": "fpga"}.__getitem__
    grouped = pkg.pareto.frontier_by_destination(
        [pt("a", 1, 4), pt("b", 2, 3), pt("a", 3, 2)],
        lambda p: dest(p.cell))
    out = pkg.pareto.dominated_destinations(
        ["cpu", "gpu", "edge", "fpga"], [pt("a", 1, 4), pt("b", 2, 3)],
        lambda p: dest(p.cell))
    assert out == ["cpu", "edge"]
    return grouped, out


def _always_on(pkg, tmp_path):
    router = _router(pkg, tmp_path)
    for r in mixed_requests(pkg, 8):
        assert router.submit(r)
    done = router.run()
    s = router.fleet_stats()
    assert (s.completed, s.prefill_tokens, s.decode_tokens, s.steps,
            s.admissions) == (8, 88, 40, 64, 8)
    assert [router.assignments[i] for i in range(8)] \
        == ["mxu_dense", "hbm_lp"] * 4
    assert s.idle_ws == 0.0 and s.wakes == 0 and s.sleeps == 0
    return _outputs(done), _fleet(router)


def _autoscale_no_clock(pkg, tmp_path):
    legacy = _router(pkg, tmp_path / "legacy")
    scaled = _router(pkg, tmp_path / "scaled", autoscale=True, min_awake=2,
                     headroom=3.0, sleep_after_s=0.5)
    outs = []
    for router in (legacy, scaled):
        for r in mixed_requests(pkg, 8):
            router.submit(r)
        done = router.run()
        router.plan()
        assert router.history[-1].power_states == {}
        assert router.history[-1].demand_tps is None
        outs.append((_outputs(done), _fleet(router)))
    assert plain(outs[0][1]["fleet"]) == plain(outs[1][1]["fleet"])
    return outs


def _clocked_plan(pkg, tmp_path):
    router = _router(pkg, tmp_path, autoscale=True, min_awake=1,
                     sleep_after_s=0.0)
    router.observe(now=0.0)
    for r in mixed_requests(pkg, 6):
        router.submit(r, now=0.0)
    router.run()
    report = router.plan(now=1.0)
    report2 = router.plan(now=100.0)
    assert report.power_states and report2.fleet is None
    assert sorted(report2.power_states.values()).count("asleep") == 2
    return report, report2, _fleet(router)


def _scale_roundtrip(pkg, tmp_path):
    router = _router(pkg, tmp_path, autoscale=True, min_awake=1,
                     sleep_after_s=0.0)
    first = router.scale_to(0.0, now=0.0)
    reqs = [pkg.rt.Request(rid=i, prompt=[1 + (i + j) % 7 for j in range(4)],
                           max_new_tokens=3) for i in range(6)]
    for r in reqs:
        assert router.submit(r, now=0.0)
    done = router.run()
    cap = sum(router.engine_capacity_tps(b) for b in router.bindings)
    second = router.scale_to(cap, now=1.0)
    for b in router.bindings:
        b.engine.check_awake(10.0)
        b.engine.accrue_idle(0.1)
    return (first, second, router.capacity_points(), _outputs(done),
            _fleet(router))


ROUTER_SCENARIOS = {
    "round_robin_cycles_engines_in_catalog_order": _round_robin,
    "energy_policy_splits_by_request_shape": _energy_split,
    "policies_are_deterministic": _deterministic,
    "slo_constrains_routing_to_feasible_engines": _slo,
    "unknown_policy_and_empty_fleet_rejected": _refusals,
    "homogeneous_fleet_gets_unique_engine_names": _homogeneous,
    "fleet_ledger_equals_sum_of_engine_ledgers": _ledger,
    "per_request_attribution_stamped": _attribution,
    "drained_requests_never_double_billed": _drain,
    "rebalance_refuses_to_drain_whole_fleet": _whole_fleet,
    "identical_silicon_twins_share_frontier_fate": _twins,
    "plan_flags_dominated_destination_for_drain": _dominated,
    "mixed_fleet_outputs_identical_to_engines_alone": _engines_alone,
    "shared_sweep_narrows_every_engine": _shared_sweep,
    "repeat_replan_hits_persistent_cache": _replan,
    "adaptive_placements_no_worse_than_static": _no_worse,
    "frontier_and_dominated_destinations": _pareto_queries,
    "always_on_pins_pre_autoscaling_outputs": _always_on,
    "autoscale_flag_changes_nothing_without_a_clock": _autoscale_no_clock,
    "plan_with_clock_scales_the_fleet": _clocked_plan,
    "scale_to_zero_then_wake_admit_drain_roundtrip": _scale_roundtrip,
}


@pytest.mark.parametrize("scenario", sorted(ROUTER_SCENARIOS))
def test_router_scenario_matches_reference(scenario, tmp_path):
    fn = ROUTER_SCENARIOS[scenario]
    want = fn(REF, tmp_path / "ref")
    got = fn(PORT, tmp_path / "port")
    assert plain(got) == plain(want)


# ---------------------------------------------------------------------------
# The lockstep executor (the reference's tests/test_concurrency.py)
# ---------------------------------------------------------------------------


def _exec_requests(pkg, n=8):
    return [pkg.rt.Request(rid=i, prompt=[1 + (i + j) % 17
                                          for j in range(10)],
                           max_new_tokens=2) if i % 2 == 0
            else pkg.rt.Request(rid=i, prompt=[1 + i % 7, 3],
                                max_new_tokens=6)
            for i in range(n)]


def _exec_router(pkg, arch="llama3.2-3b"):
    return _router(pkg, None, arch=arch, policy="round_robin", cache=False,
                   ga_config=None)


def _ledgers(router):
    return {n: dataclasses.asdict(s)
            for n, s in router.per_engine_stats().items()}


def _drained(pkg, arch, n, **run):
    router = _exec_router(pkg, arch)
    for r in _exec_requests(pkg, n):
        router.submit(r)
    done = router.run(**run)
    return _outputs(done), _ledgers(router), \
        dataclasses.asdict(router.fleet_stats())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_concurrent_run_token_and_ledger_identical(family):
    """run(concurrent=True) against the sequential drain, in the port, and
    both against the reference's concurrent run."""
    arch = FAMILIES[family]
    seq = _drained(PORT, arch, 8)
    conc = _drained(PORT, arch, 8, concurrent=True)
    assert conc == seq
    assert conc == _drained(REF, arch, 8, concurrent=True)


def test_single_worker_executor_matches_wide_pool():
    one = _drained(PORT, "llama3.2-3b", 6, concurrent=True, max_workers=1)
    wide = _drained(PORT, "llama3.2-3b", 6, concurrent=True,
                    max_workers=len(MIXED))
    assert one == wide
    assert one == _drained(REF, "llama3.2-3b", 6, concurrent=True,
                           max_workers=1)


def test_device_dwell_never_touches_the_ledger():
    """The reference's emulated device wait (``dwell_s``) leaves its drain
    as it was, so the port, which has no dwell (the card's wait is real),
    matches the reference's dwelt drain."""
    assert _drained(PORT, "llama3.2-3b", 4, concurrent=True) \
        == _drained(REF, "llama3.2-3b", 4, concurrent=True, dwell_s=0.001)
    with pytest.raises(TypeError):
        _drained(PORT, "llama3.2-3b", 4, concurrent=True, dwell_s=0.001)


def test_executor_counts_lockstep_ticks():
    ticks = {}
    for pkg in PKGS:
        router = _exec_router(pkg)
        for r in _exec_requests(pkg, 4):
            router.submit(r)
        ex = pkg.rt.FleetExecutor(router.bindings)
        done = ex.run()
        assert done and ex.ticks >= max(
            s.steps for s in router.per_engine_stats().values())
        ticks[pkg.name] = (ex.ticks, _outputs(done), _ledgers(router))
    assert ticks["port"] == ticks["ref"]


def test_executor_rejects_empty_fleet_and_negative_dwell():
    """An empty fleet is refused as in the reference; a dwell of any size
    is refused, since the port takes none."""
    for pkg in PKGS:
        with pytest.raises(ValueError):
            pkg.rt.FleetExecutor([])
    with pytest.raises(TypeError):
        PR.FleetExecutor(_exec_router(PORT).bindings, dwell_s=-1.0)


# ---------------------------------------------------------------------------
# Router-bound migration (the reference's tests/test_migration.py)
# ---------------------------------------------------------------------------


def _try_random_migration(pkg, router, rng):
    occupied = []
    for b in router.bindings:
        s = b.engine._stream
        if s is None:
            continue
        occupied += [(b, i) for i, r in enumerate(s["slot_req"])
                     if r is not None]
    if not occupied:
        return 0
    src_b, slot = occupied[rng.randrange(len(occupied))]
    targets = [b for b in router.bindings
               if b is not src_b and pkg.migration.free_slots(b.engine)]
    if not targets:
        return 0
    dst_b = targets[rng.randrange(len(targets))]
    try:
        router.migrate_slot(src_b.name, slot, dst_b.name)
    except pkg.migration.MigrationError:
        return 0
    return 1


def _arbitrary_migrations(pkg, seed):
    router = _router(pkg, None, policy="round_robin", cache=False)
    rs = [pkg.rt.Request(rid=i, prompt=[2 + i % 5, 7],
                         max_new_tokens=3 + i % 4) for i in range(6)]
    for r in rs:
        router.submit(r)
    for b in router.bindings:
        b.engine.stream_open()
    rng = random.Random(seed)
    moves = 0
    for _ in range(200):
        if not any(b.engine.stream_busy() for b in router.bindings):
            break
        for b in router.bindings:
            b.engine.stream_step()
        if rng.random() < 0.6:
            moves += _try_random_migration(pkg, router, rng)
    for b in router.bindings:
        b.engine.stream_close()
    fleet = router.fleet_stats()
    assert all(r.done for r in rs)
    assert fleet.admissions == fleet.completed == len(rs)
    assert fleet.decode_tokens == sum(len(r.output) - 1 for r in rs)
    assert fleet.migrations_in == fleet.migrations_out == moves
    for r in rs:
        assert router.assignments[r.rid] == r.served_by
    if pkg is PORT:  # the port's record of its moves
        assert len(router.moves) == moves
        last = {rid: dst for rid, _, dst in router.moves}
        assert all(router.assignments[rid] == dst
                   for rid, dst in last.items())
    return moves, _outputs(rs), _fleet(router)


@given(st.integers(0, 7))
@settings(max_examples=4, deadline=None)
def test_fleet_ledger_conserved_under_arbitrary_migrations(seed):
    assert plain(_arbitrary_migrations(PORT, seed)) \
        == plain(_arbitrary_migrations(REF, seed))


def _shed_router(pkg):
    return _router(pkg, None, policy="round_robin", cache=False,
                   saturation_factor=0.5)


def _hot_requests(pkg, n):
    return [pkg.rt.Request(rid=i, prompt=[2 + i % 5, 7], max_new_tokens=4)
            for i in range(n)]


def _live_shed(pkg):
    router = _shed_router(pkg)
    hot = router.bindings[0]
    rs = _hot_requests(pkg, 8)
    for r in rs:
        hot.engine.submit(r)
    for b in router.bindings:
        b.engine.stream_open()
    hot.engine.stream_step()
    assert router.saturated() == [hot.name]
    moved = router.rebalance(live=True)
    assert moved[hot.name] == 8 and hot.engine.stats.migrations_out == 2
    if pkg is PORT:
        assert [(src, rid) for rid, src, _ in router.moves] \
            == [(hot.name, rs[0].rid), (hot.name, rs[1].rid)]
    for _ in range(200):
        if not any(b.engine.stream_busy() for b in router.bindings):
            break
        for b in router.bindings:
            b.engine.stream_step()
    for b in router.bindings:
        b.engine.stream_close()
    assert all(r.done for r in rs)
    return moved, _outputs(rs), _fleet(router)


def _pinned(pkg):
    router = _shed_router(pkg)
    hot = router.bindings[0]
    rs = _hot_requests(pkg, 8)
    for r in rs:
        hot.engine.submit(r)
    for b in router.bindings:
        b.engine.stream_open()
    hot.engine.stream_step()
    moved = router.rebalance(live=False, include_saturated=True)
    assert moved[hot.name] == 6 and hot.engine.stats.migrations_out == 0
    if pkg is PORT:
        assert router.moves == []
    assert hot.engine._stream["slot_req"][0] is rs[0]
    for b in router.bindings:
        b.engine.stream_close()
    return moved, _fleet(router)


def _rebalance_hook(pkg):
    router = _shed_router(pkg)
    hot = router.bindings[0]
    rs = _hot_requests(pkg, 10)
    for r in rs:
        hot.engine.submit(r)
    done = router.run(concurrent=True, rebalance_every=2)
    fleet = router.fleet_stats()
    assert len(done) == len(rs) and all(r.done for r in rs)
    assert fleet.admissions == fleet.completed == len(rs)
    assert fleet.decode_tokens == sum(len(r.output) - 1 for r in rs)
    assert fleet.migrations_in == fleet.migrations_out > 0
    if pkg is PORT:
        assert len(router.moves) == fleet.migrations_in
    return _outputs(done), _fleet(router)


MIGRATION_SCENARIOS = {
    "rebalance_live_sheds_admitted_slots_off_saturated_engine": _live_shed,
    "rebalance_without_live_keeps_admitted_slots_pinned": _pinned,
    "concurrent_run_with_rebalance_hook_completes_and_conserves":
        _rebalance_hook,
}


@pytest.mark.parametrize("scenario", sorted(MIGRATION_SCENARIOS))
def test_router_migration_matches_reference(scenario):
    fn = MIGRATION_SCENARIOS[scenario]
    assert plain(fn(PORT)) == plain(fn(REF))


def test_migrate_slot_refuses_an_empty_slot():
    for pkg in PKGS:
        router = _router(pkg, None, policy="round_robin", cache=False)
        router.submit(pkg.rt.Request(rid=0, prompt=[2, 7], max_new_tokens=3))
        for b in router.bindings:
            b.engine.stream_open()
        with pytest.raises(pkg.migration.MigrationError):
            router.migrate_slot(router.bindings[0].name, 1,
                                router.bindings[1].name)
        for b in router.bindings:
            b.engine.stream_close()


# ---------------------------------------------------------------------------
# serve_fleet: the --fleet entry point
# ---------------------------------------------------------------------------


def _ref_weights(monkeypatch, arch="llama3.2-3b"):
    """The port's serve_fleet() on the reference's weights for ``arch``'s
    reduced config."""
    rcfg = ref_reduced(ref_get_config(arch))
    params = jax.tree.map(np.asarray,
                          RM.init_params(rcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(serve_mod, "M", types.SimpleNamespace(
        init_params=lambda cfg, generator: M.params_from_reference(
            cfg, params, generator.device)))


@pytest.mark.parametrize("kw", [
    {"policy": "energy"}, {"policy": "latency"}, {"policy": "round_robin"},
    {"adaptive": True}, {"provision_budget_w": 50_000.0},
], ids=["energy", "latency", "round_robin", "adaptive", "provisioned"])
def test_serve_fleet_matches_reference(kw, tmp_path, monkeypatch):
    _ref_weights(monkeypatch)
    got = serve_mod.serve_fleet("llama3.2-3b", device="cpu",
                                cache_path=str(tmp_path / "port.jsonl"),
                                **kw)
    want = ref_serve_mod.serve_fleet("llama3.2-3b",
                                     cache_path=str(tmp_path / "ref.jsonl"),
                                     **kw)
    timed = {"wall_s", "tokens_per_s"}
    assert set(got) - set(want) == {"total_tokens", "device"}
    assert {k: v for k, v in got.items() if k in want and k not in timed} \
        == {k: v for k, v in want.items() if k not in timed}
    assert got["completed"] == 8 and got["energy_ws"] > 0.0
    if "provision_budget_w" in kw:
        # the planner builds two destination types under 50 kW
        assert set(got["engines"]) == {"mxu_dense", "hbm_lp"}
    if kw.get("adaptive") or "provision_budget_w" in kw:
        assert (tmp_path / "port.jsonl").read_text() \
            == (tmp_path / "ref.jsonl").read_text()


def test_serve_fleet_cli(monkeypatch, capsys, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("sys.argv", [
        "serve", "--fleet", "--device", "cpu", "--requests", "4",
        "--max-new-tokens", "3", "--policy", "round_robin"])
    serve_mod.main()
    out = capsys.readouterr().out
    assert "served 4 requests" in out and "engine=mxu_dense" in out
    monkeypatch.setattr("sys.argv", ["serve", "--provision-budget-w", "1"])
    with pytest.raises(SystemExit):
        serve_mod.main()


def test_serve_fleet_needs_the_card_unless_asked_for_the_cpu():
    if serve_mod.torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        serve_mod.serve_fleet("llama3.2-3b")


# ---------------------------------------------------------------------------
# Launch counts under threads
# ---------------------------------------------------------------------------


def test_launch_counter_exact_under_threads():
    """8 threads x 10,000 launches through the wrappers' counting helper:
    every one is counted (``fn.launches += 1`` can lose some)."""
    def wrapper():
        pass

    wrapper.launches = wrapper.launches_tc = 0
    threads, per = 8, 10_000
    start = threading.Barrier(threads)

    def work(i):
        start.wait()
        for _ in range(per):
            if i % 2:
                count_launch(wrapper, "launches", "launches_tc")
            else:
                count_launch(wrapper)

    pool = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    assert wrapper.launches == threads * per
    assert wrapper.launches_tc == threads // 2 * per
    reset_counts(wrapper, "launches", "launches_tc")
    assert (wrapper.launches, wrapper.launches_tc) == (0, 0)
