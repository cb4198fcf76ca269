"""Fit power-model coefficients to metered traces; report model error.

The paper trusts its 27 W / 109 W constants because they were *measured*
(s-tui + nvidia-smi) on the verification machine. This module closes the
same loop for the reproduction's models: given metered Watt·s from the
telemetry layer, least-squares-fit the model coefficients and report
per-cell modeled-vs-metered error —

* :func:`fit_paper_model` — ``energy = p_cpu·t_total + p_accel·t_device``
  is linear in (p_cpu, p_accel): two or more metered runs with distinct
  device-active fractions identify both coefficients.
* :func:`fit_tpu_model` — ``energy = chips·(p_idle·t_step + p_mxu·t_c +
  p_hbm·t_m + p_ici·t_i)`` (component times pre-clamped to the step) is
  linear in the four component powers.
* :func:`error_report` — per-cell relative error between a model's closed
  form and the metered integral; the summary the fleet search and the
  serving ledger consume, and what ``PlacementController.note_metered``
  (the drift hook) thresholds to trigger an off-interval re-sweep.

Fits clamp coefficients at zero (negative watts are non-physical; with
clean synthesized traces the unclamped solution is already non-negative).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.fitness import Measurement
from repro_torch.core.power import PaperPowerModel, TpuPowerModel

FITS_SCHEMA = 1


# ---------------------------------------------------------------------------
# Metered observations
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PaperSample:
    """One metered run under the paper's host/accelerator split."""

    t_total: float
    t_device: float
    metered_ws: float

    @staticmethod
    def from_measurement(m: Measurement) -> "PaperSample":
        """From a metered Measurement whose detail carries ``t_device``
        (Himeno backends do, truncated runs included)."""
        return PaperSample(t_total=m.time_s,
                           t_device=float((m.detail or {}).get("t_device",
                                                               0.0)),
                           metered_ws=m.energy_ws)


@dataclass(frozen=True)
class TpuSample:
    """One metered step under the TPU component model."""

    chips: int
    t_step: float
    t_compute: float
    t_memory: float
    t_collective: float
    metered_ws: float
    clock: float = 1.0  # DVFS gene in effect for this sample

    @staticmethod
    def from_measurement(m: Measurement, clock: float = 1.0) -> "TpuSample":
        d = dict(m.detail or {})
        return TpuSample(chips=int(d.get("chips", 1)), t_step=m.time_s,
                         t_compute=float(d.get("t_compute", 0.0)),
                         t_memory=float(d.get("t_memory", 0.0)),
                         t_collective=float(d.get("t_collective", 0.0)),
                         metered_ws=m.energy_ws, clock=clock)


# ---------------------------------------------------------------------------
# Least-squares fits
# ---------------------------------------------------------------------------


def _nonneg_lstsq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    coef, *_ = np.linalg.lstsq(a, b, rcond=None)
    return np.maximum(coef, 0.0)


def fit_paper_model(samples: Sequence[PaperSample]) -> PaperPowerModel:
    """Fit (p_cpu, p_accel_extra) from metered runs. Needs ≥2 samples with
    distinct device-active fractions to identify both terms."""
    if len(samples) < 2:
        raise ValueError("need at least 2 metered runs to fit 2 coefficients")
    a = np.array([[s.t_total, min(s.t_device, s.t_total)] for s in samples])
    b = np.array([s.metered_ws for s in samples])
    p_cpu, p_accel = _nonneg_lstsq(a, b)
    return PaperPowerModel(p_cpu=float(p_cpu), p_accel_extra=float(p_accel))


def fit_tpu_model(samples: Sequence[TpuSample]) -> TpuPowerModel:
    """Fit (p_idle, p_mxu, p_hbm, p_ici) from metered steps.

    Samples taken under a DVFS clock expose the f³-scaled MXU power; the
    design matrix folds ``clock³`` into the MXU column so the fitted
    ``p_mxu`` is the *nominal* coefficient, directly comparable to (and
    substitutable for) the model default.
    """
    if len(samples) < 4:
        raise ValueError("need at least 4 metered steps to fit 4 coefficients")
    rows = []
    for s in samples:
        rows.append([
            s.chips * s.t_step,
            s.chips * min(s.t_compute, s.t_step) * s.clock ** 3,
            s.chips * min(s.t_memory, s.t_step),
            s.chips * min(s.t_collective, s.t_step),
        ])
    coef = _nonneg_lstsq(np.array(rows),
                         np.array([s.metered_ws for s in samples]))
    return TpuPowerModel(p_idle=float(coef[0]), p_mxu=float(coef[1]),
                         p_hbm=float(coef[2]), p_ici=float(coef[3]))


# ---------------------------------------------------------------------------
# Fit persistence (the catalog learns silicon across processes)
# ---------------------------------------------------------------------------


def save_tpu_fits(path: str, fits: Mapping[str, TpuPowerModel]) -> None:
    """Persist fitted TPU power models keyed by catalog destination name
    (``configs/destinations.py``), next to the persisted EvalCache. The
    file is the hand-off between calibration and planning:
    ``configs.destinations.calibrated_catalog`` overlays these coefficients
    onto the catalog, so a fleet provisioned tomorrow plans against the
    silicon metered today."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    record = {
        "schema": FITS_SCHEMA,
        "fits": {name: {"p_idle": m.p_idle, "p_mxu": m.p_mxu,
                        "p_hbm": m.p_hbm, "p_ici": m.p_ici}
                 for name, m in sorted(fits.items())},
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(record, fh, indent=2, sort_keys=True)


def load_tpu_fits(path: str) -> dict[str, TpuPowerModel]:
    """Load persisted fits; {} when the file is absent, unreadable or the
    wrong schema — calibration overlays must never make the catalog
    unavailable."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            record = json.load(fh)
    except (OSError, ValueError):
        return {}
    if not isinstance(record, dict) or record.get("schema") != FITS_SCHEMA:
        return {}
    out: dict[str, TpuPowerModel] = {}
    for name, coeffs in (record.get("fits") or {}).items():
        try:
            out[name] = TpuPowerModel(
                p_idle=float(coeffs["p_idle"]), p_mxu=float(coeffs["p_mxu"]),
                p_hbm=float(coeffs["p_hbm"]), p_ici=float(coeffs["p_ici"]))
        except (KeyError, TypeError, ValueError):
            continue  # a malformed entry never poisons the rest
    return out


# ---------------------------------------------------------------------------
# Modeled-vs-metered error reports
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CellError:
    """One cell's modeled-vs-metered comparison."""

    cell: str
    modeled_ws: float
    metered_ws: float

    @property
    def rel_error(self) -> float:
        """(modeled - metered) / metered: positive = model over-predicts."""
        if self.metered_ws == 0.0:
            return 0.0 if self.modeled_ws == 0.0 else float("inf")
        return (self.modeled_ws - self.metered_ws) / self.metered_ws


@dataclass
class CalibrationReport:
    """Per-cell error table + summary statistics."""

    cells: list[CellError]

    @property
    def max_abs_rel_error(self) -> float:
        return max((abs(c.rel_error) for c in self.cells), default=0.0)

    @property
    def mean_abs_rel_error(self) -> float:
        if not self.cells:
            return 0.0
        return sum(abs(c.rel_error) for c in self.cells) / len(self.cells)

    @property
    def rmse_ws(self) -> float:
        if not self.cells:
            return 0.0
        return float(np.sqrt(np.mean(
            [(c.modeled_ws - c.metered_ws) ** 2 for c in self.cells])))

    def worst(self) -> Optional[CellError]:
        return max(self.cells, key=lambda c: abs(c.rel_error), default=None)

    def to_json(self) -> dict:
        return {
            "cells": [{"cell": c.cell, "modeled_ws": c.modeled_ws,
                       "metered_ws": c.metered_ws, "rel_error": c.rel_error}
                      for c in self.cells],
            "max_abs_rel_error": self.max_abs_rel_error,
            "mean_abs_rel_error": self.mean_abs_rel_error,
            "rmse_ws": self.rmse_ws,
        }


def error_report(pairs: Iterable[tuple[str, float, float]]
                 ) -> CalibrationReport:
    """Build a report from (cell, modeled_ws, metered_ws) triples."""
    return CalibrationReport([CellError(c, mo, me) for c, mo, me in pairs])


def report_from_metered(measurements: Iterable[tuple[str, Measurement]]
                        ) -> CalibrationReport:
    """Build a report straight from metered Measurements (the
    ``detail["metered"]`` record a :class:`~repro_torch.telemetry.backends.
    MeteredBackend` attaches)."""
    pairs = []
    for cell, m in measurements:
        rec = (m.detail or {}).get("metered")
        if rec is None:
            continue
        pairs.append((cell, rec["modeled_ws"], rec["metered_ws"]))
    return error_report(pairs)
