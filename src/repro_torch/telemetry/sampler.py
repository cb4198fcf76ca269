"""Sampled power sources: counter-backed when the machine has them, modeled
always.

The paper's verification environment *measures* watts by polling live power
counters (s-tui for the CPU package, nvidia-smi for the accelerator, §4) and
multiplying by seconds. This module is that polling layer:

* :class:`CounterSampler` — reads RAPL energy counters
  (``/sys/class/powercap/intel-rapl*/energy_uj``, the counters s-tui itself
  polls) and ``nvidia-smi``'s instantaneous ``power.draw`` when either source
  exists, and degrades gracefully to ``available = False`` when neither does
  (a machine without counters; CI asserts the fallback).
* :class:`ModeledSampler` — a deterministic stand-in synthesized from the
  same quantities the analytic models use: a piecewise-constant per-domain
  watts timeline (phases), built from a :class:`~repro_torch.core.power.
  PaperPowerModel` run split (host vs device-active seconds) or from
  :class:`~repro_torch.core.power.RooflineTerms` component utilizations with the
  DVFS clock gene applied. Its virtual-clock traces integrate (trapezoid,
  see telemetry/meter.py) to the closed-form model energies, which is what
  lets the meter path be tested bit-deterministically on machines with no
  counters at all.
* :class:`TraceRecorder` — a background thread that polls any sampler at a
  configurable Hz into a timestamped :class:`PowerTrace`.

Traces are per-domain (``cpu``/``accel`` for the paper split; ``idle``/
``mxu``/``hbm``/``ici`` for the TPU model) so integration can attribute
Watt·s to components, and idle-baseline subtraction (the paper's
steady-state methodology) stays a trace operation.
"""
from __future__ import annotations

import glob
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional, Protocol, Sequence

from repro_torch.core.power import PaperPowerModel, RooflineTerms, TpuPowerModel


# ---------------------------------------------------------------------------
# Trace containers
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PowerSample:
    """One instant: seconds since trace start -> watts per power domain."""

    t: float
    watts: Mapping[str, float]

    @property
    def total(self) -> float:
        return sum(self.watts.values())


@dataclass
class PowerTrace:
    """Timestamped samples from one recording session."""

    samples: list[PowerSample] = field(default_factory=list)
    source: str = "modeled"
    hz: float = 0.0

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def duration_s(self) -> float:
        if len(self.samples) < 2:
            return 0.0
        return self.samples[-1].t - self.samples[0].t

    def domains(self) -> tuple[str, ...]:
        seen: dict[str, None] = {}
        for s in self.samples:
            for d in s.watts:
                seen.setdefault(d)
        return tuple(seen)

    def totals(self) -> list[tuple[float, float]]:
        return [(s.t, s.total) for s in self.samples]


# ---------------------------------------------------------------------------
# Sampler protocol
# ---------------------------------------------------------------------------


class PowerSampler(Protocol):
    """Anything the meter can poll for instantaneous per-domain watts."""

    name: str

    @property
    def available(self) -> bool: ...

    def domains(self) -> tuple[str, ...]: ...

    def read(self) -> dict[str, float]: ...


# ---------------------------------------------------------------------------
# Counter-backed sampler (RAPL + NVML-style sources)
# ---------------------------------------------------------------------------

RAPL_ROOT = "/sys/class/powercap"


class CounterSampler:
    """Polls real power counters when the machine exposes them.

    RAPL exposes monotonic *energy* counters (µJ); watts are the discrete
    derivative between successive reads, so the first ``read`` of a domain
    reports 0 W (no interval yet). ``nvidia-smi`` reports instantaneous
    draw directly. On machines with neither source — CPU-only hosts, CI —
    ``available`` is False, ``domains()`` is empty and ``read()`` returns
    ``{}``: callers degrade to the :class:`ModeledSampler` path instead of
    crashing (the graceful-fallback contract the fast-tier smoke test pins).
    """

    name = "counters"

    def __init__(self, rapl_root: str = RAPL_ROOT,
                 nvidia_smi: Optional[str] = "nvidia-smi",
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._rapl: dict[str, str] = {}  # domain name -> energy_uj path
        self._last: dict[str, tuple[float, float]] = {}  # domain -> (t, uj)
        try:
            for zone in sorted(glob.glob(os.path.join(rapl_root,
                                                      "intel-rapl:*"))):
                energy = os.path.join(zone, "energy_uj")
                if not os.path.isfile(energy):
                    continue
                try:
                    with open(os.path.join(zone, "name")) as fh:
                        label = fh.read().strip() or os.path.basename(zone)
                    # probe readability once: energy_uj is often root-only
                    with open(energy) as fh:
                        int(fh.read().strip())
                except (OSError, ValueError):
                    continue
                self._rapl[f"rapl:{label}"] = energy
        except OSError:
            pass
        self._smi = shutil.which(nvidia_smi) if nvidia_smi else None
        if self._smi is not None and self._read_gpu() is None:
            # binary present but no working GPU (common in CUDA-base
            # images): a sampler that would only ever read {} must not
            # report available, or callers would integrate 0 W traces
            # instead of degrading to the modeled path
            self._smi = None

    @property
    def available(self) -> bool:
        return bool(self._rapl) or self._smi is not None

    def domains(self) -> tuple[str, ...]:
        out = tuple(self._rapl)
        if self._smi is not None:
            out += ("gpu",)
        return out

    def _read_rapl(self, domain: str, path: str, now: float) -> float:
        try:
            with open(path) as fh:
                uj = float(fh.read().strip())
        except (OSError, ValueError):
            return 0.0
        prev = self._last.get(domain)
        self._last[domain] = (now, uj)
        if prev is None:
            return 0.0
        dt = now - prev[0]
        duj = uj - prev[1]
        if dt <= 0.0 or duj < 0.0:  # counter wrap: skip one interval
            return 0.0
        return duj * 1e-6 / dt

    def _read_gpu(self) -> Optional[float]:
        try:
            out = subprocess.run(
                [self._smi, "--query-gpu=power.draw",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=2.0)
            if out.returncode != 0:
                return None
            vals = [float(v) for v in out.stdout.split() if v]
            return sum(vals) if vals else None
        except (OSError, ValueError, subprocess.SubprocessError):
            return None

    def read(self) -> dict[str, float]:
        now = self._clock()
        watts = {d: self._read_rapl(d, p, now)
                 for d, p in self._rapl.items()}
        if self._smi is not None:
            gpu = self._read_gpu()
            if gpu is not None:
                watts["gpu"] = gpu
        return watts


# ---------------------------------------------------------------------------
# Modeled sampler (deterministic synthesis)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PowerPhase:
    """A span of constant per-domain watts on the synthesized timeline."""

    name: str
    duration_s: float
    watts: Mapping[str, float]


class ModeledSampler:
    """Deterministic sampler over a piecewise-constant watts timeline.

    ``read()`` walks a virtual clock (each call advances by ``1/hz``) so a
    background recorder can poll it like a real counter; ``trace()`` skips
    the thread entirely and synthesizes the whole uniformly-sampled trace in
    one call — the deterministic path tests and ``power_bench`` use.
    """

    name = "modeled"

    def __init__(self, phases: Sequence[PowerPhase], hz: float = 100.0):
        if hz <= 0:
            raise ValueError("hz must be positive")
        self.phases = tuple(phases)
        self.hz = hz
        self._cursor = 0

    # -- builders ------------------------------------------------------
    @staticmethod
    def from_paper_run(t_total: float, t_device: float,
                       power: PaperPowerModel = PaperPowerModel(),
                       hz: float = 100.0) -> "ModeledSampler":
        """The paper's §4 split: host watts for the whole run, accelerator
        watts while the device is active (taken as one leading span — the
        attribution the closed-form ``PaperPowerModel.energy`` makes)."""
        t_total = max(t_total, 0.0)
        t_dev = min(max(t_device, 0.0), t_total)
        phases = []
        if t_dev > 0.0:
            phases.append(PowerPhase("offload", t_dev,
                                     {"cpu": power.p_cpu,
                                      "accel": power.p_accel_extra}))
        if t_total - t_dev > 0.0:
            phases.append(PowerPhase("host", t_total - t_dev,
                                     {"cpu": power.p_cpu, "accel": 0.0}))
        return ModeledSampler(phases, hz=hz)

    @staticmethod
    def from_roofline(terms: RooflineTerms,
                      power: TpuPowerModel = TpuPowerModel(),
                      clock: float = 1.0, overlap: bool = True,
                      hz: float = 100.0) -> "ModeledSampler":
        """Per-domain watts from the three roofline component utilizations —
        the terms passed in must already carry the DVFS 1/f time stretch
        (``analyze_cell`` builds them from the clock-scaled peak)."""
        return ModeledSampler.from_components(
            terms.step_time(overlap), terms.t_compute, terms.t_memory,
            terms.t_collective, terms.chips, power=power, clock=clock,
            overlap=overlap, hz=hz)

    @staticmethod
    def from_components(t_step: float, t_compute: float, t_memory: float,
                        t_collective: float, chips: int,
                        power: TpuPowerModel = TpuPowerModel(),
                        clock: float = 1.0, overlap: bool = True,
                        hz: float = 100.0) -> "ModeledSampler":
        """Per-domain watts from component-active seconds.

        Each component draws its full power while active and the components
        run concurrently from t=0 when overlapped (active times clamp at the
        step, mirroring ``TpuPowerModel.energy``); sequential execution lays
        them end to end. The DVFS ``clock`` gene scales MXU dynamic power by
        f³ (the active times must already carry the 1/f stretch).
        """
        if clock != 1.0:
            power = TpuPowerModel(p_idle=power.p_idle,
                                  p_mxu=power.p_mxu * clock ** 3,
                                  p_hbm=power.p_hbm, p_ici=power.p_ici)
        comps = [("mxu", min(t_compute, t_step), power.p_mxu),
                 ("hbm", min(t_memory, t_step), power.p_hbm),
                 ("ici", min(t_collective, t_step), power.p_ici)]
        phases: list[PowerPhase] = []
        if overlap:
            # boundary times where some component switches off
            cuts = sorted({t for _, t, _ in comps} | {0.0, t_step})
            for a, b in zip(cuts[:-1], cuts[1:]):
                if b - a <= 0.0:
                    continue
                watts = {"idle": power.p_idle * chips}
                for name, t_on, p in comps:
                    watts[name] = p * chips if t_on > a else 0.0
                phases.append(PowerPhase(f"[{a:.3g},{b:.3g})", b - a, watts))
        else:
            for name, t_on, p in comps:
                if t_on <= 0.0:
                    continue
                watts = {"idle": power.p_idle * chips,
                         "mxu": 0.0, "hbm": 0.0, "ici": 0.0}
                watts[name] = p * chips
                phases.append(PowerPhase(name, t_on, watts))
            if not phases and t_step > 0.0:
                phases.append(PowerPhase("idle", t_step,
                                         {"idle": power.p_idle * chips}))
        return ModeledSampler(phases, hz=hz)

    # -- timeline ------------------------------------------------------
    @property
    def duration_s(self) -> float:
        return sum(p.duration_s for p in self.phases)

    def _all_domains(self) -> tuple[str, ...]:
        seen: dict[str, None] = {}
        for p in self.phases:
            for d in p.watts:
                seen.setdefault(d)
        return tuple(seen)

    def watts_at(self, t: float) -> dict[str, float]:
        """Right-continuous piecewise lookup; 0 W outside the timeline."""
        zeros = {d: 0.0 for d in self._all_domains()}
        if t < 0.0:
            return zeros
        acc = 0.0
        for p in self.phases:
            if t < acc + p.duration_s:
                return {**zeros, **dict(p.watts)}
            acc += p.duration_s
        return zeros

    # -- sampler protocol ---------------------------------------------
    @property
    def available(self) -> bool:
        return True

    def domains(self) -> tuple[str, ...]:
        return self._all_domains()

    def read(self) -> dict[str, float]:
        t = self._cursor / self.hz
        self._cursor += 1
        return self.watts_at(t)

    # -- deterministic synthesis --------------------------------------
    def trace(self, hz: Optional[float] = None) -> PowerTrace:
        """Uniformly sample the whole timeline (endpoint included) without
        threads or wall clocks — same sample spacing a live recorder at
        ``hz`` would produce, but exactly reproducible."""
        hz = hz or self.hz
        total = self.duration_s
        n = max(1, int(round(total * hz)))
        dt = total / n
        samples = [PowerSample(i * dt, self.watts_at(i * dt))
                   for i in range(n)]
        # endpoint carries the last phase's watts so a constant timeline
        # integrates to exactly W × t under the trapezoid rule
        last = self.watts_at(max(total - dt * 0.5, 0.0))
        samples.append(PowerSample(total, last))
        return PowerTrace(samples=samples, source=self.name, hz=hz)


# ---------------------------------------------------------------------------
# Background recorder
# ---------------------------------------------------------------------------


class TraceRecorder:
    """Polls a sampler on a background thread at ``hz`` into a PowerTrace.

    ``start()``/``stop()`` bracket a recording session; timestamps are
    seconds since ``start``. A final sample is taken at ``stop`` so short
    sessions still produce an integrable (≥2 samples) trace.
    """

    def __init__(self, sampler: PowerSampler, hz: float = 20.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if hz <= 0:
            raise ValueError("hz must be positive")
        self.sampler = sampler
        self.hz = hz
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = 0.0
        self._samples: list[PowerSample] = []

    def _loop(self) -> None:
        period = 1.0 / self.hz
        while not self._stop.is_set():
            t = self._clock() - self._t0
            self._samples.append(PowerSample(t, self.sampler.read()))
            self._stop.wait(period)

    def start(self) -> "TraceRecorder":
        if self._thread is not None:
            raise RuntimeError("recorder already started")
        self._stop.clear()
        self._samples = []
        self._t0 = self._clock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="power-trace-recorder")
        self._thread.start()
        return self

    def stop(self) -> PowerTrace:
        if self._thread is None:
            raise RuntimeError("recorder not started")
        self._stop.set()
        self._thread.join()
        self._thread = None
        self._samples.append(PowerSample(self._clock() - self._t0,
                                         self.sampler.read()))
        return PowerTrace(samples=self._samples,
                          source=getattr(self.sampler, "name", "unknown"),
                          hz=self.hz)

    def elapsed(self) -> float:
        return self._clock() - self._t0
