"""The port's paper loop against the JAX package: GA, app, verifier
backends, cache serialisation and power telemetry. Pure-Python layers must
agree bit for bit; the app's numerics to 1e-4 relative."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.apps.himeno_app import HimenoApp as RefApp
from repro.core import cache_store as ref_cache
from repro.core.arithmetic_intensity import himeno_unit_costs as ref_costs
from repro.core.fitness import Measurement as RefMeasurement
from repro.core.ga import GAConfig as RefGAConfig
from repro.core.offload_search import search_himeno as ref_search
from repro.core import verifier as ref_verifier
from repro.telemetry import backends as ref_backends
from repro.telemetry import meter as ref_meter
from repro.telemetry import sampler as ref_sampler
from repro_torch.apps.himeno_app import LOOP_UNITS, UNIT_NAMES, HimenoApp
from repro_torch.core import cache_store
from repro_torch.core.arithmetic_intensity import himeno_unit_costs
from repro_torch.core.fitness import Measurement
from repro_torch.core.ga import GAConfig
from repro_torch.core.offload_search import search_himeno
from repro_torch.core import verifier
from repro_torch.telemetry import backends, meter, sampler

ALL_CPU = {u: 0 for u in UNIT_NAMES}
ALL_DEV = {u: 1 for u in UNIT_NAMES}
PAPER = {u: int(u in LOOP_UNITS) for u in UNIT_NAMES}
PAPER_BITS = tuple(PAPER[u] for u in UNIT_NAMES)
PROFILES = ("GPU_2080TI", "MANYCORE", "FPGA")


def _fields(m):
    return dataclasses.asdict(m)


def _bits(seed, n=8):
    rng = np.random.default_rng(seed)
    return [tuple(int(x) for x in rng.integers(0, 2, 13)) for _ in range(n)]


# ---------------------------------------------------------------------------
# GA parity (the README quickstart)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2])
def test_ga_parity_calibrated(seed):
    ours = search_himeno(verifier.HimenoCalibratedBackend(),
                         GAConfig(population=12, generations=12, seed=seed))
    ref = ref_search(ref_verifier.HimenoCalibratedBackend(),
                     RefGAConfig(population=12, generations=12, seed=seed))
    assert ours.best.genome == ref.best.genome
    assert ours.best.fitness == ref.best.fitness
    assert _fields(ours.best.measurement) == _fields(ref.best.measurement)
    assert ours.evaluations == ref.evaluations
    assert ours.cache_hits == ref.cache_hits
    assert [[r.genome for r in g] for g in ours.history] == \
        [[r.genome for r in g] for g in ref.history]


@pytest.mark.parametrize("profile", PROFILES)
def test_calibrated_backend_identical(profile):
    ours = verifier.HimenoCalibratedBackend(
        device=getattr(verifier, profile))
    ref = ref_verifier.HimenoCalibratedBackend(
        device=getattr(ref_verifier, profile))
    assert ours.unit_names() == ref.unit_names()
    for bits in _bits(0) + [(0,) * 13, (1,) * 13]:
        assert _fields(ours.measure_bits(bits)) == \
            _fields(ref.measure_bits(bits))


def test_unit_costs_and_anchors_identical():
    for grid, iters in (((512, 256, 256), 62), ((17, 17, 33), 3)):
        assert [dataclasses.asdict(u) for u in himeno_unit_costs(grid, iters)] \
            == [dataclasses.asdict(u) for u in ref_costs(grid, iters)]
    for name in ("PAPER_GRID", "PAPER_CPU_TIME_S", "PAPER_GPU_TIME_S",
                 "PAPER_CPU_WATTS", "PAPER_GPU_WATTS", "PAPER_CPU_ENERGY",
                 "PAPER_GPU_ENERGY"):
        assert getattr(verifier, name) == getattr(ref_verifier, name)


# ---------------------------------------------------------------------------
# App parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [(9, 9, 17), (17, 17, 33)])
@pytest.mark.parametrize("placement", [ALL_CPU, ALL_DEV, PAPER],
                         ids=["all_cpu", "all_device", "loop_units"])
def test_app_parity(grid, placement):
    app = HimenoApp(grid=grid, iters=3, device="cpu")
    ours = app.run(placement)
    ref = RefApp(grid=grid, iters=3).run(placement)
    for key in ("gosa", "final_residual"):
        assert ours.detail[key] == pytest.approx(ref.detail[key], rel=1e-4)
    assert ours.detail["placement"] == ref.detail["placement"]
    assert not ours.timed_out and ours.detail["truncated"] is False
    assert ours.energy_ws == pytest.approx(
        app.power.energy(ours.time_s, ours.detail["t_device"]))


def test_verify_numerics():
    assert HimenoApp(grid=(9, 9, 17), iters=3,
                     device="cpu").verify_numerics() < 1e-5


def test_budget_truncated_run_reports_through_power_path():
    """A budget-exhausted run reports t_device and modeled energy the same
    way a completed run does — not a free (0 W·s) timeout."""
    app = HimenoApp(grid=(17, 17, 33), iters=50, device="cpu")
    placement = dict(ALL_DEV)
    m = app.run(placement, budget_s=1e-6)
    assert m.timed_out
    assert m.detail["truncated"] is True
    assert m.detail["placement"] == placement
    t_dev = m.detail["t_device"]
    assert 0.0 <= t_dev <= m.time_s
    assert m.energy_ws == pytest.approx(app.power.energy(m.time_s, t_dev))
    assert m.avg_watts == pytest.approx(
        app.power.average_watts(m.time_s, t_dev))
    assert m.energy_ws > 0.0
    done = app.run(placement, budget_s=None)
    assert done.detail["truncated"] is False
    assert set(m.detail) <= set(done.detail) | {"truncated"}


def test_measured_backend_small_ga():
    backend = verifier.HimenoMeasuredBackend(
        HimenoApp(grid=(9, 9, 17), iters=2, device="cpu"), budget_s=10.0)
    res = search_himeno(backend, GAConfig(population=6, generations=4,
                                          seed=0))
    assert res.best.measurement.time_s > 0
    assert res.evaluations <= 24
    assert res.best.measurement.detail["t_device"] >= 0.0


def test_app_device_defaults_to_card():
    if torch.cuda.is_available():
        assert HimenoApp().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            HimenoApp()


# ---------------------------------------------------------------------------
# Pure-Python identity: cache serialisation
# ---------------------------------------------------------------------------


MEASUREMENTS = [
    dict(time_s=1.5, energy_ws=40.5),
    dict(time_s=0.1, energy_ws=2.0, timed_out=True, avg_watts=20.0),
    dict(time_s=3.0, energy_ws=90.0, feasible=False,
         detail={"t_device": 0.25, "placement": {"init_p": 1}}),
]
KEYS = [("cell", (1, 0, 1)), "plain", 3, ("a", 1.25, (None, True))]


@pytest.mark.parametrize("kw", MEASUREMENTS)
def test_measurement_json_identical(kw):
    ours = cache_store.measurement_to_json(Measurement(**kw))
    ref = ref_cache.measurement_to_json(RefMeasurement(**kw))
    assert ours == ref
    back = cache_store.measurement_from_json(ours)
    assert _fields(back) == _fields(ref_cache.measurement_from_json(ref))


@pytest.mark.parametrize("key", KEYS)
def test_stable_key_identical(key):
    assert cache_store.stable_key(key) == ref_cache.stable_key(key)


# ---------------------------------------------------------------------------
# Power telemetry
# ---------------------------------------------------------------------------


def _trace_tuple(trace):
    return ([(s.t, dict(s.watts)) for s in trace.samples], trace.source,
            trace.hz)


@pytest.mark.parametrize("t_total,t_device,hz", [(153.0, 0.0, 10.0),
                                                 (19.0, 14.5, 100.0),
                                                 (0.02, 0.013, 200.0)])
def test_modeled_paper_trace_identical(t_total, t_device, hz):
    ours = sampler.ModeledSampler.from_paper_run(t_total, t_device, hz=hz)
    ref = ref_sampler.ModeledSampler.from_paper_run(t_total, t_device, hz=hz)
    t_ours, t_ref = ours.trace(), ref.trace()
    assert _trace_tuple(t_ours) == _trace_tuple(t_ref)
    assert meter.trapezoid_ws(t_ours) == ref_meter.trapezoid_ws(t_ref)
    assert meter.trapezoid_ws(t_ours, domains=("accel",), t0=0.001,
                              t1=t_total * 0.7) == \
        ref_meter.trapezoid_ws(t_ref, domains=("accel",), t0=0.001,
                               t1=t_total * 0.7)


@pytest.mark.parametrize("overlap", [True, False])
def test_modeled_component_trace_identical(overlap):
    args = (0.01, 0.006, 0.009, 0.002, 4)
    ours = sampler.ModeledSampler.from_components(*args, clock=0.85,
                                                  overlap=overlap).trace()
    ref = ref_sampler.ModeledSampler.from_components(*args, clock=0.85,
                                                     overlap=overlap).trace()
    assert _trace_tuple(ours) == _trace_tuple(ref)
    assert meter.trapezoid_ws(ours) == ref_meter.trapezoid_ws(ref)


def test_meter_spans_identical():
    ours_tr = sampler.ModeledSampler.from_paper_run(2.0, 0.5).trace()
    ref_tr = ref_sampler.ModeledSampler.from_paper_run(2.0, 0.5).trace()
    marks = (("idle", 1.5, 2.0), ("offload", 0.0, 0.5))
    ours = meter.meter_trace(ours_tr, marks=marks)
    ref = ref_meter.meter_trace(ref_tr, marks=marks)
    assert (ours.total_ws, ours.idle_watts, ours.net_ws) == \
        (ref.total_ws, ref.idle_watts, ref.net_ws)
    assert {n: dataclasses.astuple(s) for n, s in ours.spans.items()} == \
        {n: dataclasses.astuple(s) for n, s in ref.spans.items()}


@pytest.mark.parametrize("profile", PROFILES)
def test_metered_backend_synthesized_identical(profile):
    ours = backends.MeteredBackend(verifier.HimenoCalibratedBackend(
        device=getattr(verifier, profile)))
    ref = ref_backends.MeteredBackend(ref_verifier.HimenoCalibratedBackend(
        device=getattr(ref_verifier, profile)))
    assert ours.unit_names() == ref.unit_names()
    for bits in _bits(1, n=4) + [PAPER_BITS]:
        assert _fields(ours.measure_bits(bits)) == \
            _fields(ref.measure_bits(bits))


@pytest.mark.parametrize("duration", [0.0, 1e-3, 153.0])
def test_effective_hz_identical(duration):
    assert backends.effective_hz(duration, 200.0) == \
        ref_backends.effective_hz(duration, 200.0)


def test_counter_sampler_without_counters(tmp_path):
    ours = sampler.CounterSampler(rapl_root=str(tmp_path), nvidia_smi=None)
    assert ours.available is False
    assert ours.domains() == () and ours.read() == {}
    # both packages probe the same sources the same way on this host
    assert sampler.CounterSampler().domains() == \
        ref_sampler.CounterSampler().domains()


def test_counter_sampler_sums_every_gpu(tmp_path):
    """nvidia-smi lists one power.draw line per GPU; the sampler sums them,
    as the reference does."""
    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/sh\necho 71.5\necho 120.25\n")
    smi.chmod(0o755)
    ours = sampler.CounterSampler(rapl_root=str(tmp_path), nvidia_smi=str(smi))
    ref = ref_sampler.CounterSampler(rapl_root=str(tmp_path),
                                     nvidia_smi=str(smi))
    assert ours.available and ours.domains() == ("gpu",)
    assert ours.read() == ref.read() == {"gpu": 191.75}
