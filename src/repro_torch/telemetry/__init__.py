"""Metered power telemetry: sampled Watt·s traces and model calibration.

The paper *verifies* power reduction by sampling live power counters during
and after automatic offloading and integrating Watt·seconds (§4, Fig.5);
``core/power.py`` only models watts. This package is the measurement side:

* ``sampler``  — power sources: counter-backed (RAPL / nvidia-smi, graceful
  fallback when absent) and deterministic modeled synthesis; background
  trace recording at configurable Hz.
* ``meter``    — trapezoid Watt·s integration over traces, named spans
  (warmup / steady / idle) and idle-baseline subtraction.
* ``backends`` — ``MeteredBackend`` wrapping any measurement backend under
  the meter; the ``"metered"`` fleet-cell backend (registered on import)
  so ``search_fleet`` cells can be meter-backed through the shared
  ``EvalEngine`` cache.
* ``calibrate``— least-squares fits of the power models from metered
  traces, and modeled-vs-metered error reports.
"""
from repro_torch.telemetry.sampler import (
    CounterSampler, ModeledSampler, PowerPhase, PowerSample, PowerSampler,
    PowerTrace, TraceRecorder,
)
from repro_torch.telemetry.meter import (
    EnergyMeter, MeterReading, SpanReading, average_watts, finalize_trace,
    meter_trace, trapezoid_ws,
)
from repro_torch.telemetry.backends import (
    DEFAULT_HZ, MeteredBackend, effective_hz, metered_lm_backend,
)
from repro_torch.telemetry.calibrate import (
    CalibrationReport, CellError, PaperSample, TpuSample, error_report,
    fit_paper_model, fit_tpu_model, load_tpu_fits, report_from_metered,
    save_tpu_fits,
)

__all__ = [
    "CounterSampler", "ModeledSampler", "PowerPhase", "PowerSample",
    "PowerSampler", "PowerTrace", "TraceRecorder",
    "EnergyMeter", "MeterReading", "SpanReading", "average_watts",
    "finalize_trace", "meter_trace", "trapezoid_ws",
    "DEFAULT_HZ", "MeteredBackend", "effective_hz", "metered_lm_backend",
    "CalibrationReport", "CellError", "PaperSample", "TpuSample",
    "error_report", "fit_paper_model", "fit_tpu_model", "load_tpu_fits",
    "report_from_metered", "save_tpu_fits",
]
