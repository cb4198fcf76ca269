"""Mixed-environment offload-destination catalog (arXiv:2011.12431).

The paper's follow-up evaluates automatic offloading when *several*
destination kinds sit side by side — GPU, FPGA, many-core CPU — and each
kernel class has a different best home. The TPU adaptation of that setting
is a catalog of *slices that differ in silicon, not just size*: each
:class:`DestinationSpec` pairs a mesh shape with its own
:class:`~repro_torch.core.power.TpuPowerModel`, so the same workload cell costs
differently per destination and the fleet router
(``runtime/router.py``) has a real energy tradeoff to exploit:

* ``pod_v5e``    — the balanced production slice (paper-faithful default
  coefficients). Jack of all trades, master of none.
* ``pod2_v5e``   — the same silicon, twice the slice: strictly faster at
  equal modeled energy, so ``pod_v5e`` is Pareto-dominated whenever both
  are in the fleet — the router's drain/rebalance demonstration case.
* ``mxu_dense``  — a compute-optimized part (efficient tensor cores, power-
  hungry memory system): cheapest Watt·s/token for compute-bound *prefill*.
* ``hbm_lp``     — a low-power memory-optimized inference part on a small
  slice (cheap HBM, low idle floor, weak matrix units): cheapest
  Watt·s/token for memory-bound *decode*, at higher step time.

``verify_cost_s`` orders staged §3.3 verification (paper: many-core CPU
costs almost nothing to verify, FPGA hours): small efficiency parts verify
cheaply, big pods are the expensive targets.

The catalog is deliberately small and explicit — callers and tests
reference destinations by name, and ``mixed_fleet()`` returns the standard
heterogeneous line-up.

Counterpart of the JAX package's ``configs/destinations.py``, copied as it
is: the destinations are priced by ``TpuPowerModel`` (TPU v5e silicon and
its variants), so their Watt·s are the model's, not the card's.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from repro_torch.core.power import TpuPowerModel

# Die area of one chip in the catalog's abstract area unit (the provisioning
# layer's chip-area budgets are relative, like lumos's area fractions — the
# unit cancels as long as specs and budgets use the same one).
CHIP_AREA_UNITS = 1.0


@dataclass(frozen=True)
class DestinationSpec:
    """One offload destination: a mesh *on specific silicon*.

    ``name`` is the catalog label requests are reported against
    (``Request.destination``); ``verify_cost_s`` is the stand-in staged-
    verification cost for §3.3 cheap-to-expensive ordering."""

    name: str
    mesh: tuple[tuple[str, int], ...]  # sorted (axis, size) items
    power: TpuPowerModel
    verify_cost_s: float
    description: str = ""
    # Energy-proportional power states (FleetRouter autoscaling): waking a
    # slept slice costs wall-clock seconds (counted against SLOs by the
    # router), and the DVFS-floor / deep-sleep standby states draw these
    # fractions of the awake idle floor (p_idle x chips). Small efficiency
    # parts wake fast; big pods pay real spin-up latency.
    wake_s: float = 0.0
    floor_frac: float = 0.4
    sleep_frac: float = 0.05
    floor_wake_s: float = 0.0
    # Slice die area for provisioning area budgets; 0.0 = default from the
    # mesh size (chips x CHIP_AREA_UNITS) in __post_init__.
    area: float = 0.0

    def __post_init__(self) -> None:
        def bad(msg: str) -> ValueError:
            return ValueError(f"DestinationSpec {self.name!r}: {msg}")

        if not self.name:
            raise bad("name must be non-empty")
        if not self.mesh or any(v <= 0 for _, v in self.mesh):
            raise bad(f"mesh axes must all be positive, got {self.mesh!r}")
        for coeff in ("p_idle", "p_mxu", "p_hbm", "p_ici"):
            w = getattr(self.power, coeff)
            if w < 0.0:
                raise bad(f"power.{coeff} = {w} W is negative — a slice "
                          "cannot generate energy (idle_watts and every "
                          "component draw must be >= 0)")
        if self.verify_cost_s < 0.0:
            raise bad(f"verify_cost_s = {self.verify_cost_s} must be >= 0")
        for frac in ("floor_frac", "sleep_frac"):
            v = getattr(self, frac)
            if not 0.0 <= v <= 1.0:
                raise bad(f"{frac} = {v} must lie in [0, 1] (a fraction of "
                          "the awake idle floor)")
        if self.wake_s < 0.0 or self.floor_wake_s < 0.0:
            raise bad("wake latencies must be >= 0")
        if self.wake_s < self.floor_wake_s:
            raise bad(f"wake_s = {self.wake_s} < floor_wake_s = "
                      f"{self.floor_wake_s}: waking from deep sleep cannot "
                      "be faster than waking from the DVFS floor")
        if self.area < 0.0:
            raise bad(f"area = {self.area} must be >= 0")
        if self.area == 0.0:
            object.__setattr__(self, "area", self.chips * CHIP_AREA_UNITS)

    @property
    def mesh_shape(self) -> dict[str, int]:
        return dict(self.mesh)

    @property
    def chips(self) -> int:
        n = 1
        for _, v in self.mesh:
            n *= v
        return n

    @property
    def idle_watts(self) -> float:
        """Awake static draw of the whole slice: the power model's idle
        floor x chips — exactly the term the telemetry meter's idle-baseline
        subtraction quantifies, and what an always-on fleet burns per
        second whether or not a single token flows."""
        return self.power.p_idle * self.chips

    @property
    def peak_watts(self) -> float:
        """Nameplate draw of the whole slice: every component active at
        full utilization. What power delivery must be built to stand the
        destination up — the number a provisioning Watt budget
        (``repro_torch.provision``) debits, whether or not the slice ever runs
        that hot."""
        p = self.power
        return (p.p_idle + p.p_mxu + p.p_hbm + p.p_ici) * self.chips


def _spec(name: str, mesh_shape: dict[str, int], power: TpuPowerModel,
          verify_cost_s: float, description: str, wake_s: float = 0.0,
          floor_wake_s: float = 0.0) -> DestinationSpec:
    return DestinationSpec(name, tuple(sorted(mesh_shape.items())), power,
                           verify_cost_s, description, wake_s=wake_s,
                           floor_wake_s=floor_wake_s)


DESTINATIONS: dict[str, DestinationSpec] = {
    d.name: d for d in (
        _spec("pod_v5e", {"data": 16, "model": 16}, TpuPowerModel(),
              verify_cost_s=256.0,
              description="balanced 256-chip production slice",
              wake_s=2e-3, floor_wake_s=1e-4),
        _spec("pod2_v5e", {"data": 16, "model": 16, "pod": 2},
              TpuPowerModel(),
              verify_cost_s=512.0,
              description="2-pod slice: same silicon, half the step time",
              wake_s=4e-3, floor_wake_s=2e-4),
        _spec("mxu_dense", {"data": 16, "model": 16},
              TpuPowerModel(p_idle=20.0, p_mxu=55.0, p_hbm=19.0,
                            p_ici=10.0),
              verify_cost_s=384.0,
              description="inference-tuned compute part: efficient tensor "
                          "cores and a lean idle floor — prefill's best "
                          "home, a close second on decode",
              wake_s=1e-3, floor_wake_s=5e-5),
        _spec("hbm_lp", {"data": 4, "model": 16},
              TpuPowerModel(p_idle=22.0, p_mxu=180.0, p_hbm=14.0,
                            p_ici=8.0),
              verify_cost_s=64.0,
              description="low-power memory-optimized inference part on a "
                          "small slice — decode's best home, slow prefill",
              wake_s=5e-4, floor_wake_s=2e-5),
    )
}


def mixed_fleet(names: tuple[str, ...] = ("pod2_v5e", "mxu_dense", "hbm_lp")
                ) -> list[DestinationSpec]:
    """The standard heterogeneous line-up: one fast balanced slice, one
    compute-optimized, one memory-optimized. ``pod_v5e`` is left out by
    default because ``pod2_v5e`` Pareto-dominates it (include it explicitly
    to exercise drain/rebalance)."""
    return [DESTINATIONS[n] for n in names]


# Where telemetry calibration persists fitted coefficients (next to the
# persisted EvalCache, so calibration accumulates across processes).
DEFAULT_FITS_PATH = "results/power_fits.json"


def calibrated_catalog(
    fits_path: str = DEFAULT_FITS_PATH,
    base: Optional[dict[str, DestinationSpec]] = None,
) -> dict[str, DestinationSpec]:
    """The catalog with learned silicon: destinations whose name has a
    persisted :func:`repro_torch.telemetry.calibrate.fit_tpu_model` fit
    (saved by ``telemetry.calibrate.save_tpu_fits``) get their documented power
    model replaced by the fitted coefficients; everything else keeps the
    catalog default. Missing or unreadable fit files degrade to the plain
    catalog, so provisioning and routing can always ask for the calibrated
    view.

    Replacing ``power`` re-runs ``__post_init__`` validation, so a
    non-physical fit (negative watts — impossible from the clamped
    least-squares, but possible from a hand-edited file) is rejected
    loudly rather than silently planned against.
    """
    catalog = dict(base if base is not None else DESTINATIONS)
    from repro_torch.telemetry.calibrate import load_tpu_fits

    for name, model in load_tpu_fits(fits_path).items():
        spec = catalog.get(name)
        if spec is not None:
            catalog[name] = replace(spec, power=model)
    return catalog
