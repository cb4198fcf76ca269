"""The port's open-loop traffic generator, forecasts and virtual-clock fleet
replay against the JAX package's, on the CPU.

The generator runs on ``random`` and ``hashlib`` alone, so the port's traces
must be byte-identical to the reference's for every spec (``trace_bytes``,
``trace_digest``), over a range of seeds and both arrival processes.
Forecasts are pure arithmetic over a trace: equal field by field.
``simulate`` replays one trace against a fleet of the reduced llama3.2-3b
in float32 on the reference's weights, carried across: its ``SimReport``
(ledger, finish times, power log, migrations), the routing and every
engine's ledger must equal the reference's, every float with ``==``, also
with autoscaling ticks and live rebalancing (mid-flight slot moves) on.
"""
import dataclasses
import functools
import types

import jax
import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from _parity import plain
from repro import models as RM
from repro import runtime as RR
from repro import workload as RW
from repro.configs import get_config as ref_get_config
from repro.configs import mixed_fleet as ref_mixed_fleet
from repro.configs import reduced as ref_reduced
from repro.workload import forecast as RF
from repro_torch import models as M
from repro_torch import runtime as PR
from repro_torch import workload as W
from repro_torch.configs import get_config, mixed_fleet, reduced
from repro_torch.workload import forecast as F

REF = types.SimpleNamespace(name="ref", rt=RR, wl=RW, fc=RF,
                            mixed_fleet=ref_mixed_fleet, dev={})
PORT = types.SimpleNamespace(name="port", rt=PR, wl=W, fc=F,
                             mixed_fleet=mixed_fleet, dev={"device": "cpu"})


def _tenants(pkg):
    return (pkg.wl.TenantSpec("chat", weight=3.0, prompt_median=6,
                              prompt_max=14, new_tokens_median=4,
                              new_tokens_max=8, slo_s=0.05),
            pkg.wl.TenantSpec("batch", weight=1.0, prompt_median=10,
                              prompt_max=20, new_tokens_median=6,
                              new_tokens_max=10))


def _spec(pkg, **kw):
    kw.setdefault("seed", 0)
    kw.setdefault("duration_s", 1.0)
    kw.setdefault("rate_rps", 200.0)
    kw.setdefault("max_len", 32)
    return pkg.wl.WorkloadSpec(**kw)


def _trace_record(trace):
    return [(t.at_s, t.tenant, t.request.rid, tuple(t.request.prompt),
             t.request.max_new_tokens, t.request.slo_s, t.request.eos_id)
            for t in trace]


# ---------------------------------------------------------------------------
# Generator: byte-identical traces
# ---------------------------------------------------------------------------


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       arrival=st.sampled_from(["poisson", "bursty"]))
def test_traces_byte_identical_to_reference(seed, arrival):
    kw = dict(seed=seed, arrival=arrival, rate_rps=150.0,
              diurnal_period_s=1.0, diurnal_trough=0.3, diurnal_peak=1.8)
    got = W.generate(_spec(PORT, tenants=_tenants(PORT), **kw))
    want = RW.generate(_spec(REF, tenants=_tenants(REF), **kw))
    assert W.trace_bytes(got) == RW.trace_bytes(want)
    assert W.trace_digest(got) == RW.trace_digest(want)
    assert _trace_record(got) == _trace_record(want)


@pytest.mark.parametrize("kw", [
    {},
    {"arrival": "bursty", "burst_rate_mult": 6.0, "burst_mean_s": 0.05,
     "quiet_mean_s": 0.1},
    {"rate_rps": 800.0, "diurnal_period_s": 1.0, "diurnal_trough": 0.1,
     "diurnal_peak": 2.0},
    {"max_len": 16, "reserve_output": False},
    {"max_len": 4},
], ids=["flat", "bursty", "diurnal", "no_reserve", "short"])
def test_generator_helpers_match_reference(kw):
    got_spec = _spec(PORT, tenants=_tenants(PORT), **kw)
    want_spec = _spec(REF, tenants=_tenants(REF), **kw)
    got, want = W.generate(got_spec, rid_base=100), \
        RW.generate(want_spec, rid_base=100)
    assert _trace_record(got) == _trace_record(want)
    assert W.trace_digest(got) == RW.trace_digest(want)
    assert W.empirical_rate_rps(got, 1.0) == RW.empirical_rate_rps(want, 1.0)
    assert W.mean_diurnal_mult(got_spec) == RW.mean_diurnal_mult(want_spec)
    for t in (0.0, 0.1, 0.25, 0.5, 0.9):
        assert W.diurnal_mult(got_spec, t) == RW.diurnal_mult(want_spec, t)
    assert W.ARRIVALS == RW.ARRIVALS


def test_spec_validation_matches_reference():
    bad = [{"arrival": "uniform"}, {"rate_rps": 0.0}, {"duration_s": 0.0},
           {"max_len": 1}, {"tenants": ()},
           {"diurnal_period_s": 1.0, "diurnal_trough": 2.0,
            "diurnal_peak": 1.0}]
    for kw in bad:
        for pkg in (REF, PORT):
            with pytest.raises(ValueError):
                _spec(pkg, **kw)


# ---------------------------------------------------------------------------
# Forecasts
# ---------------------------------------------------------------------------


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 1000),
       arrival=st.sampled_from(["poisson", "bursty"]))
def test_forecast_from_spec_matches_reference(seed, arrival):
    kw = dict(seed=seed, duration_s=0.06, rate_rps=15000.0, max_len=32,
              arrival=arrival, diurnal_period_s=0.06, diurnal_trough=0.15,
              diurnal_peak=2.0)
    got = F.WorkloadForecast.from_spec(_spec(PORT, tenants=_tenants(PORT),
                                             **kw))
    want = RF.WorkloadForecast.from_spec(_spec(REF, tenants=_tenants(REF),
                                               **kw))
    assert plain(got) == plain(want)
    assert plain(got.slo_tenants()) == plain(want.slo_tenants())


def test_forecast_from_trace_hand_counts_match_reference():
    def forecast(pkg):
        trace = [
            pkg.wl.TimedRequest(at_s=0.0, tenant="t", request=pkg.rt.Request(
                rid=0, prompt=[1, 2, 3], max_new_tokens=5)),
            pkg.wl.TimedRequest(at_s=9.0, tenant="t", request=pkg.rt.Request(
                rid=1, prompt=[1], max_new_tokens=1)),
        ]
        return [pkg.fc.WorkloadForecast.from_trace(trace, 10.0,
                                                   peak_windows=w)
                for w in (1, 4, 10)]

    got, want = forecast(PORT), forecast(REF)
    assert plain(got) == plain(want)
    fc = got[-1]
    assert (fc.total_tokens, fc.mean_tps, fc.peak_tps) == (10, 1.0, 8.0)
    assert fc.prefill_frac == 4 / 10 and fc.tenants[0].prompt_median == 1


# ---------------------------------------------------------------------------
# simulate: the virtual-clock replay
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models(arch="llama3.2-3b"):
    changes = {"dtype": "float32"}
    rcfg = dataclasses.replace(ref_reduced(ref_get_config(arch)), **changes)
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    model = M.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    "cpu")
    return {"ref": (rcfg, params), "port": (cfg, model)}


# (trace spec, router options, simulate options): the smoke's replay, an
# always-on fleet over a fixed horizon, a diurnal autoscaled one with plan
# passes, and a latency-routed one shedding live slots off saturation
SIMS = {
    "bursty_autoscaled_live_rebalance": (
        dict(seed=0, duration_s=0.012, rate_rps=2400.0, max_len=64,
             arrival="bursty"),
        dict(autoscale=True, saturation_factor=1.0, max_len=64),
        dict(autoscale_every_s=0.002, rebalance_every_s=0.001,
             rebalance_live=True)),
    "always_on_horizon": (
        dict(seed=3, duration_s=0.02, rate_rps=600.0, max_len=32),
        dict(),
        dict(horizon_s=0.05)),
    "diurnal_autoscaled_with_plans": (
        dict(seed=7, duration_s=0.02, rate_rps=1500.0, max_len=32,
             diurnal_period_s=0.02, diurnal_trough=0.15, diurnal_peak=2.0),
        dict(autoscale=True, sleep_after_s=0.002),
        dict(autoscale_every_s=0.002, plan_times=(0.008, 0.016),
             horizon_s=0.03)),
    "latency_queue_drain": (
        dict(seed=1, duration_s=0.01, rate_rps=3000.0, max_len=32,
             arrival="bursty"),
        dict(policy="latency", saturation_factor=0.5),
        dict(rebalance_every_s=0.0005)),
    "latency_live_rebalance": (
        dict(seed=1, duration_s=0.01, rate_rps=3000.0, max_len=32,
             arrival="bursty"),
        dict(policy="latency", saturation_factor=0.5, autoscale=True),
        dict(autoscale_every_s=0.001, rebalance_every_s=0.0005,
             rebalance_live=True)),
}


def _simulate(pkg, tmp_path, name):
    spec_kw, router_kw, sim_kw = SIMS[name]
    trace = pkg.wl.generate(pkg.wl.WorkloadSpec(tenants=_tenants(pkg),
                                                **spec_kw))
    router_kw = dict(router_kw)
    router_kw.setdefault("max_len", 32)
    cfg, weights = _models()[pkg.name]
    router = pkg.rt.FleetRouter(
        cfg, weights, pkg.mixed_fleet(), arch="llama3.2-3b", slots=2,
        cache_path=str(tmp_path / pkg.name / "cache.jsonl"),
        ga_config=None, **router_kw, **pkg.dev)
    report = pkg.wl.simulate(router, trace, **sim_kw)
    fleet = router.fleet_stats()
    for f in pkg.rt.EngineStats.__dataclass_fields__:
        assert getattr(fleet, f) == pytest.approx(sum(
            getattr(s, f) for s in router.per_engine_stats().values())), f
    assert report.completed == report.submitted == len(trace)
    return {"report": report, "total_ws": report.total_ws,
            "ws_per_1k_tokens": report.ws_per_1k_tokens,
            "engines": router.per_engine_stats(),
            "assignments": dict(router.assignments),
            "outputs": [(t.rid, tuple(t.request.output),
                         t.request.finish_reason, t.request.served_by)
                        for t in trace],
            "history": [(h.demand_tps, h.power_states, h.new_measurements,
                         h.placements) for h in router.history]}


@pytest.mark.parametrize("name", sorted(SIMS))
def test_simulate_report_matches_reference(name, tmp_path):
    got = _simulate(PORT, tmp_path, name)
    want = _simulate(REF, tmp_path, name)
    assert plain(got) == plain(want)
    report = got["report"]
    assert report.fleet.migrations_in == report.fleet.migrations_out \
        == report.migrations
    if name == "bursty_autoscaled_live_rebalance":
        # the smoke's replay moves at least one live slot
        assert report.migrations >= 1 and report.power_log


def test_simulate_twice_on_one_router_bills_deltas():
    def twice(pkg):
        spec_kw, router_kw, sim_kw = SIMS["always_on_horizon"]
        cfg, weights = _models()[pkg.name]
        router = pkg.rt.FleetRouter(
            cfg, weights, pkg.mixed_fleet(), arch="llama3.2-3b", slots=2,
            max_len=32, cache_path=None, **pkg.dev)
        out = []
        for seed in (3, 4):
            trace = pkg.wl.generate(pkg.wl.WorkloadSpec(
                tenants=_tenants(pkg), **dict(spec_kw, seed=seed)))
            out.append(pkg.wl.simulate(router, trace, **sim_kw))
        return out

    got, want = twice(PORT), twice(REF)
    assert plain(got) == plain(want)
    assert got[1].submitted == got[1].completed
