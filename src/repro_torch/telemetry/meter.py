"""Watt·second integration over sampled power traces.

The paper computes Watt·s as (sampled watts) × (seconds) per phase of a run,
comparing steady state after offloading against a CPU-only run and quoting
the difference (§4, Fig.5). This module is that arithmetic, generalized to
timestamped traces:

* :func:`trapezoid_ws` — trapezoidal time-integral of a trace's watts
  (optionally a subset of domains, optionally a sub-interval with linear
  interpolation at the edges). Constant traces integrate to exactly W × t
  and denser sampling of the same timeline is refinement-stable — the two
  invariants the tier-1 tests pin.
* :class:`EnergyMeter` — a context manager that records a trace around a
  workload and splits it into named spans (``warmup`` / ``steady`` /
  ``idle`` ...): ``with EnergyMeter(sampler) as m: ... with m.span("steady"):
  ...``. The reading reports per-span Watt·s and average watts, plus an
  idle-baseline-subtracted net energy when an idle span (or explicit idle
  watts) establishes the machine's floor — the paper's
  steady-state-minus-idle methodology.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from repro_torch.telemetry.sampler import (
    PowerSampler, PowerTrace, TraceRecorder,
)


# ---------------------------------------------------------------------------
# Trace integration
# ---------------------------------------------------------------------------


def _sample_total(sample, domains: Optional[Sequence[str]]) -> float:
    if domains is None:
        return sample.total
    return sum(sample.watts.get(d, 0.0) for d in domains)


def trapezoid_ws(trace: PowerTrace, *,
                 domains: Optional[Sequence[str]] = None,
                 t0: Optional[float] = None,
                 t1: Optional[float] = None) -> float:
    """Watt·seconds under the trace between ``t0`` and ``t1`` (defaults:
    whole trace), by the trapezoid rule with linear interpolation at cut
    points. Fewer than two samples integrate to 0 (no interval)."""
    pts = [(s.t, _sample_total(s, domains)) for s in trace.samples]
    pts.sort(key=lambda p: p[0])
    if len(pts) < 2:
        return 0.0
    lo = pts[0][0] if t0 is None else max(t0, pts[0][0])
    hi = pts[-1][0] if t1 is None else min(t1, pts[-1][0])
    if hi <= lo:
        return 0.0

    def value_at(t: float, i: int) -> float:
        """Linear interpolation on segment i -> i+1 (t inside it)."""
        ta, wa = pts[i]
        tb, wb = pts[i + 1]
        if tb <= ta:
            return wb
        f = (t - ta) / (tb - ta)
        return wa + (wb - wa) * f

    total = 0.0
    for i in range(len(pts) - 1):
        ta, wa = pts[i]
        tb, wb = pts[i + 1]
        a, b = max(ta, lo), min(tb, hi)
        if b <= a:
            continue
        va = wa if a == ta else value_at(a, i)
        vb = wb if b == tb else value_at(b, i)
        total += 0.5 * (va + vb) * (b - a)
    return total


def average_watts(trace: PowerTrace, *,
                  domains: Optional[Sequence[str]] = None,
                  t0: Optional[float] = None,
                  t1: Optional[float] = None) -> float:
    if len(trace.samples) < 2:
        return 0.0
    lo = trace.samples[0].t if t0 is None else t0
    hi = trace.samples[-1].t if t1 is None else t1
    dur = hi - lo
    if dur <= 0.0:
        return 0.0
    return trapezoid_ws(trace, domains=domains, t0=lo, t1=hi) / dur


# ---------------------------------------------------------------------------
# Named spans + idle subtraction
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpanReading:
    """One named interval of a metered run."""

    name: str
    t0: float
    t1: float
    energy_ws: float
    avg_watts: float

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def net_ws(self, idle_watts: float) -> float:
        """Idle-baseline-subtracted Watt·s (clamped at 0: a span can never
        owe energy)."""
        return max(self.energy_ws - idle_watts * self.duration_s, 0.0)


@dataclass
class MeterReading:
    """Everything one metered session produced."""

    trace: PowerTrace
    spans: dict[str, SpanReading] = field(default_factory=dict)
    total_ws: float = 0.0
    duration_s: float = 0.0
    idle_watts: float = 0.0  # established baseline (0 when none measured)

    @property
    def avg_watts(self) -> float:
        return self.total_ws / self.duration_s if self.duration_s else 0.0

    @property
    def idle_ws(self) -> float:
        """Watt·s of the established idle baseline over the session: the
        floor energy ``net_ws`` subtracts (``idle_watts x duration``). This
        is the same static-draw quantity the serving fleet charges a
        spun-down engine (``EngineStats.idle_ws``) — the cross-check the
        energy-proportional tests pin: an engine held in one power state
        for T seconds books exactly what a metered constant trace at that
        state's watts integrates to."""
        return self.idle_watts * self.duration_s

    @property
    def net_ws(self) -> float:
        """Total Watt·s above the idle floor — the paper's reported delta."""
        return max(self.total_ws - self.idle_watts * self.duration_s, 0.0)

    def span_net_ws(self, name: str) -> float:
        return self.spans[name].net_ws(self.idle_watts)


def finalize_trace(trace: PowerTrace,
                   marks: Sequence[tuple[str, float, float]] = (),
                   idle_watts: float = 0.0) -> MeterReading:
    """Integrate a trace against named span marks. The idle baseline is the
    explicit ``idle_watts`` or, failing that, the average watts of a span
    literally named ``"idle"`` — the paper's practice of quoting
    steady-state draw above the machine's floor."""
    spans: dict[str, SpanReading] = {}
    for name, t0, t1 in marks:
        e = trapezoid_ws(trace, t0=t0, t1=t1)
        dur = max(t1 - t0, 0.0)
        spans[name] = SpanReading(name, t0, t1, e, e / dur if dur else 0.0)
    idle = idle_watts
    if not idle and "idle" in spans and spans["idle"].duration_s > 0:
        idle = spans["idle"].avg_watts
    return MeterReading(trace=trace, spans=spans,
                        total_ws=trapezoid_ws(trace),
                        duration_s=trace.duration_s,
                        idle_watts=idle)


class EnergyMeter:
    """Record → span → integrate, as a context manager.

    ``idle_watts`` seeds the baseline explicitly (e.g. a prior quiescent
    measurement); alternatively a span literally named ``"idle"`` measured
    during the session establishes it — its average watts become the floor
    that ``net_ws`` subtracts, matching the paper's practice of quoting
    steady-state draw above the machine's idle.
    """

    def __init__(self, sampler: PowerSampler, hz: float = 20.0, *,
                 idle_watts: float = 0.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.sampler = sampler
        self.hz = hz
        self.idle_watts = idle_watts
        self._clock = clock
        self._recorder = TraceRecorder(sampler, hz=hz, clock=clock)
        self._marks: list[tuple[str, float, float]] = []
        self.reading: Optional[MeterReading] = None

    # -- session -------------------------------------------------------
    def __enter__(self) -> "EnergyMeter":
        self._marks = []
        self.reading = None
        self._recorder.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        trace = self._recorder.stop()
        self.reading = self.finalize(trace)

    @contextmanager
    def span(self, name: str):
        """Mark a named interval of the live session."""
        t0 = self._recorder.elapsed()
        try:
            yield self
        finally:
            self._marks.append((name, t0, self._recorder.elapsed()))

    def finalize(self, trace: PowerTrace,
                 marks: Optional[Sequence[tuple[str, float, float]]] = None
                 ) -> MeterReading:
        """Integrate a trace against this meter's recorded (or supplied)
        span marks."""
        return finalize_trace(trace,
                              marks=self._marks if marks is None else marks,
                              idle_watts=self.idle_watts)


def meter_trace(trace: PowerTrace,
                marks: Sequence[tuple[str, float, float]] = (),
                idle_watts: float = 0.0) -> MeterReading:
    """One-shot offline metering of an already-recorded (or synthesized)
    trace — what the deterministic ``ModeledSampler`` path uses."""
    return finalize_trace(trace, marks=marks, idle_watts=idle_watts)
