"""Power & energy models.

Two calibrations (DESIGN.md §6):

* ``PaperPowerModel`` — the paper's measured constants for the Himeno
  reproduction: 27 W CPU-only; 109 W while CPU+GPU are active (§4.2, Fig.5).
  Energy(W·s) = 27·t_total + 82·t_device_active.

* ``TpuPowerModel`` — parametric per-chip model for the TPU v5e target.
  Component utilizations come from the three roofline terms; watts are a
  documented model, not a measurement.
"""
from __future__ import annotations

from dataclasses import dataclass


# ---------------------------------------------------------------------------
# Hardware target (TPU v5e, constants mandated by the assignment)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12  # bf16 FLOP/s per chip
    hbm_bw: float = 819e9  # B/s per chip
    ici_bw: float = 50e9  # B/s per link
    hbm_bytes: float = 16e9  # per-chip HBM capacity
    vmem_bytes: float = 16 * 2**20


TPU_V5E = HardwareSpec()


# ---------------------------------------------------------------------------
# Paper-calibrated model (Himeno reproduction)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PaperPowerModel:
    """Watts measured in the paper's verification environment (§4)."""

    p_cpu: float = 27.0  # W, host busy (s-tui measurement in the paper)
    p_accel_extra: float = 82.0  # W, additional while accelerator active
    # (27 + 82 = 109 W — the paper's nvidia-smi + s-tui reading under offload)

    def average_watts(self, t_total: float, t_device: float) -> float:
        t_total = max(t_total, 1e-12)
        return self.p_cpu + self.p_accel_extra * min(t_device / t_total, 1.0)

    def energy(self, t_total: float, t_device: float) -> float:
        """Watt-seconds for a run with t_device seconds of accelerator work."""
        return self.p_cpu * t_total + self.p_accel_extra * min(t_device, t_total)


# ---------------------------------------------------------------------------
# TPU parametric model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TpuPowerModel:
    """Per-chip component power at full utilization (documented estimates)."""

    p_idle: float = 60.0
    p_mxu: float = 110.0
    p_hbm: float = 35.0
    p_ici: float = 10.0

    @property
    def tag(self) -> str:
        """Stable short label derived from the coefficients, used to
        namespace fleet-cell labels when cells carry per-destination power
        models (a mixed-environment fleet sweeps the same mesh under
        different silicon; their results must never collide)."""
        return (f"i{self.p_idle:g}m{self.p_mxu:g}"
                f"h{self.p_hbm:g}c{self.p_ici:g}")

    def average_watts(self, t_step: float, t_compute: float, t_memory: float,
                      t_collective: float) -> float:
        """Per-chip watts given roofline component-active times."""
        t_step = max(t_step, 1e-12)
        u = lambda t: min(t / t_step, 1.0)
        return (self.p_idle + self.p_mxu * u(t_compute)
                + self.p_hbm * u(t_memory) + self.p_ici * u(t_collective))

    def energy(self, chips: int, t_step: float, t_compute: float,
               t_memory: float, t_collective: float) -> float:
        """Joules per step across the slice. Component energies are
        time-integrals of active power, so they do NOT depend on overlap —
        only the idle term scales with wall time. This is what makes
        short-time and low-energy *different* objectives, as in the paper."""
        return chips * (
            self.p_idle * t_step
            + self.p_mxu * min(t_compute, t_step)
            + self.p_hbm * min(t_memory, t_step)
            + self.p_ici * min(t_collective, t_step)
        )


@dataclass(frozen=True)
class RooflineTerms:
    """The three §Roofline terms, in seconds, plus their inputs."""

    flops: float  # total FLOPs for the step (all chips)
    hbm_bytes: float  # total HBM traffic (all chips)
    collective_bytes: float  # total wire bytes (all chips)
    chips: int
    hw: HardwareSpec = TPU_V5E

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.hw.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * self.hw.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * self.hw.ici_bw)

    def step_time(self, overlap: bool = True) -> float:
        terms = (self.t_compute, self.t_memory, self.t_collective)
        return max(terms) if overlap else sum(terms)

    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def energy(self, model: TpuPowerModel, overlap: bool = True) -> float:
        t = self.step_time(overlap)
        return model.energy(self.chips, t, self.t_compute, self.t_memory,
                            self.t_collective)
