"""Meter-backed measurement backends.

``MeteredBackend`` wraps any existing verification backend (the Himeno
measured/calibrated backends — anything exposing ``measure_bits``) so its
Watt·seconds come from an *integrated power trace* instead of the
closed-form model:

* with a live sampler passed explicitly (or picked by
  :meth:`MeteredBackend.auto` on a machine whose counters actually read)
  the inner run is recorded by a background :class:`~repro_torch.telemetry.
  sampler.TraceRecorder` and integrated. Live metering is only meaningful
  when the inner backend physically performs the work
  (``HimenoMeasuredBackend``) — wrapping a closed-form backend live would
  integrate the microseconds of model arithmetic, not the workload;
* by default — and always for model-backed inners — the trace is
  *synthesized* by the deterministic :class:`~repro_torch.telemetry.sampler.
  ModeledSampler` from the inner measurement's own timeline (total vs
  device-active seconds) and then integrated by the same trapezoid path, so
  benches and tests behave identically on machines with and without
  counters.

Either way the returned :class:`~repro_torch.core.fitness.Measurement`
carries the metered energy, keeps the model's closed-form value in
``detail["metered"]["modeled_ws"]``, and reports their relative error — the
modeled-vs-metered comparison ``telemetry/calibrate.py`` fits against.

``metered_lm_backend`` is the fleet-cell form, registered under the name
``"metered"`` (see :func:`repro_torch.core.evaluator.register_backend`): a
``CellSpec(..., backend="metered")`` cell then evaluates meter-backed through
the same engine and cache as its model-backed neighbours.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Callable, Optional, Sequence

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.evaluator import register_backend
from repro_torch.core.fitness import Measurement
from repro_torch.core.lm_cost_model import Decisions, analyze_cell
from repro_torch.core.power import PaperPowerModel, TpuPowerModel
from repro_torch.telemetry.meter import EnergyMeter, meter_trace, trapezoid_ws
from repro_torch.telemetry.sampler import (
    CounterSampler, ModeledSampler, PowerSampler, PowerTrace,
)

DEFAULT_HZ = 200.0
MIN_SAMPLES = 256  # floor on samples per synthesized trace


def effective_hz(duration_s: float, hz: float,
                 min_samples: int = MIN_SAMPLES) -> float:
    """Raise the sampling rate for very short runs so a synthesized trace
    always has enough points for the trapezoid integral to stay within the
    2% model-agreement budget; long runs keep the configured Hz (a 153 s
    CPU-only Himeno run does not need a million samples)."""
    if duration_s <= 0.0:
        return hz
    return max(hz, min_samples / duration_s)


def _metered_detail(m: Measurement, metered_ws: float, trace: PowerTrace,
                    spans: Optional[dict] = None) -> dict:
    modeled = m.energy_ws
    err = ((metered_ws - modeled) / modeled) if modeled else 0.0
    detail = dict(m.detail or {})
    detail["metered"] = {
        "metered_ws": metered_ws,
        "modeled_ws": modeled,
        "model_error": err,
        "trace_source": trace.source,
        "trace_samples": len(trace),
        "trace_hz": trace.hz,
        **({"spans": spans} if spans else {}),
    }
    return detail


def _remeter(m: Measurement, metered_ws: float, trace: PowerTrace,
             spans: Optional[dict] = None) -> Measurement:
    t = max(m.time_s, 1e-12)
    return replace(m, energy_ws=metered_ws, avg_watts=metered_ws / t,
                   detail=_metered_detail(m, metered_ws, trace, spans))


class MeteredBackend:
    """Wrap a ``measure_bits`` backend so energy is trace-integrated.

    ``sampler=None`` (the default) uses the deterministic synthesized
    :class:`ModeledSampler` path. Pass an available :class:`CounterSampler`
    (or use :meth:`auto`) to record live traces — only do that when the
    inner backend really executes the workload; a closed-form inner returns
    in microseconds and a live trace around it integrates to ~0 W·s.
    Pass ``power`` to override the :class:`PaperPowerModel` used for
    synthesis (default: the inner backend's own model when it has one).
    """

    def __init__(self, inner, *, sampler: Optional[PowerSampler] = None,
                 hz: float = DEFAULT_HZ,
                 power: Optional[PaperPowerModel] = None) -> None:
        self.inner = inner
        self.hz = hz
        self.power = power or self._inner_power(inner)
        self.sampler = sampler  # None => synthesize per measurement

    @staticmethod
    def auto(inner, *, hz: float = DEFAULT_HZ,
             power: Optional[PaperPowerModel] = None) -> "MeteredBackend":
        """Live counters when this machine's actually read (RAPL/NVML probe
        passed), synthesized traces otherwise — for inners that physically
        run the workload (e.g. ``HimenoMeasuredBackend``)."""
        counters = CounterSampler()
        return MeteredBackend(inner,
                              sampler=counters if counters.available else None,
                              hz=hz, power=power)

    @staticmethod
    def _inner_power(inner) -> PaperPowerModel:
        p = getattr(inner, "power", None)
        if p is None:
            p = getattr(getattr(inner, "app", None), "power", None)
        return p if isinstance(p, PaperPowerModel) else PaperPowerModel()

    # -- backend protocol ---------------------------------------------
    def unit_names(self) -> tuple[str, ...]:
        return self.inner.unit_names()

    def measure_bits(self, bits: Sequence[int]) -> Measurement:
        if self.sampler is not None:
            return self._measure_live(bits)
        return self._measure_synthesized(bits)

    # -- live counters -------------------------------------------------
    def _measure_live(self, bits: Sequence[int]) -> Measurement:
        meter = EnergyMeter(self.sampler, hz=self.hz)
        with meter:
            with meter.span("run"):
                m = self.inner.measure_bits(bits)
        reading = meter.reading
        metered = reading.spans["run"].energy_ws or reading.total_ws
        spans = {n: s.energy_ws for n, s in reading.spans.items()}
        return _remeter(m, metered, reading.trace, spans)

    # -- synthesized (no counters) ------------------------------------
    def _measure_synthesized(self, bits: Sequence[int]) -> Measurement:
        m = self.inner.measure_bits(bits)
        t_total = m.time_s
        t_dev = float((m.detail or {}).get("t_device", 0.0))
        sampler = ModeledSampler.from_paper_run(
            t_total, t_dev, self.power, hz=effective_hz(t_total, self.hz))
        trace = sampler.trace()
        reading = meter_trace(trace, marks=(("offload", 0.0, min(t_dev,
                                                                 t_total)),
                                            ("host", min(t_dev, t_total),
                                             t_total)))
        spans = {n: s.energy_ws for n, s in reading.spans.items()}
        return _remeter(m, reading.total_ws, trace, spans)


def metered_lm_backend(
    cfg: ArchConfig,
    shape: ShapeSpec,
    mesh_shape: dict[str, int],
    power: TpuPowerModel = TpuPowerModel(),
    *,
    hz: float = DEFAULT_HZ,
    true_power: Optional[TpuPowerModel] = None,
) -> Callable[[Decisions], Measurement]:
    """Meter-backed measure function for one LM fleet cell.

    Runs the analytic model for the *time* side, then synthesizes the
    per-domain watts trace from the cell's roofline component utilizations
    (DVFS clock applied) and integrates it — the metered energy. With
    ``true_power`` the trace is synthesized under a different ("real
    machine") power model than the one the cost model assumes, which is how
    calibration experiments create a modeled-vs-metered gap to fit.
    """
    synth_power = true_power or power

    def measure(dec: Decisions) -> Measurement:
        cost = analyze_cell(cfg, shape, mesh_shape, dec, power=power)
        if not cost.fits:
            return Measurement(time_s=cost.step_time, energy_ws=cost.energy,
                               feasible=False, detail=cost.breakdown)
        modeled = Measurement(
            time_s=cost.step_time, energy_ws=cost.energy,
            avg_watts=cost.energy / max(cost.step_time, 1e-12)
            / cost.terms.chips,
            detail=cost.breakdown)
        sampler = ModeledSampler.from_components(
            cost.step_time, cost.terms.t_compute, cost.terms.t_memory,
            cost.terms.t_collective, cost.terms.chips, power=synth_power,
            clock=dec.clock, overlap=dec.overlap,
            hz=effective_hz(cost.step_time, hz))
        trace = sampler.trace()
        return _remeter(modeled, trapezoid_ws(trace), trace)

    return measure


# Fleet cells opt in with CellSpec(..., backend="metered"). Importing
# repro_torch.telemetry is what makes the name available (core never
# imports up).
register_backend("metered", metered_lm_backend)
