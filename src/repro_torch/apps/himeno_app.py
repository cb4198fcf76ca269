"""The paper's §4 evaluation workload: Himeno benchmark with 13 offloadable
loop statements, runnable under any CPU/device placement genome.

Mirrors the paper's setup: the CPU path is NumPy (the paper's Python/NumPy),
the device path is PyTorch on the card (the paper's CuPy), with the stencil
units going through kernel B1 (``kernels/himeno/kernel.py``). Unit
boundaries are the 13 parallelizable loop statements the paper's Clang step
finds; arrays migrate between host and device only at placement boundaries,
so the GA can discover the transfer-batching behaviour of [31] (contiguous
device units keep intermediates resident — no per-loop transfers).

Power is modeled with the paper's own measured constants (27 W host,
+82 W accelerator-active → 109 W); time is measured wall-clock.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.fitness import Measurement
from repro_torch.core.power import PaperPowerModel
from repro_torch.kernels.himeno.kernel import himeno_stencil

UNIT_NAMES = (
    "init_p", "init_a012", "init_a3", "init_b", "init_c", "init_bnd",
    "init_wrk1", "init_wrk2",
    "jacobi_stencil", "gosa_reduction", "wrk2_write", "p_update",
    "final_residual",
)
LOOP_UNITS = ("jacobi_stencil", "gosa_reduction", "wrk2_write", "p_update")
OMEGA = 0.8


# ---------------------------------------------------------------------------
# Unit implementations — NumPy (host) and PyTorch (device)
# ---------------------------------------------------------------------------


def _np_stencil(p, a, b, c, bnd, wrk1):
    C = slice(1, -1)
    P, N = slice(2, None), slice(0, -2)
    s0 = (a[0][C, C, C] * p[P, C, C] + a[1][C, C, C] * p[C, P, C]
          + a[2][C, C, C] * p[C, C, P]
          + b[0][C, C, C] * (p[P, P, C] - p[P, N, C] - p[N, P, C] + p[N, N, C])
          + b[1][C, C, C] * (p[C, P, P] - p[C, N, P] - p[C, P, N] + p[C, N, N])
          + b[2][C, C, C] * (p[P, C, P] - p[N, C, P] - p[P, C, N] + p[N, C, N])
          + c[0][C, C, C] * p[N, C, C] + c[1][C, C, C] * p[C, N, C]
          + c[2][C, C, C] * p[C, C, N] + wrk1[C, C, C])
    return (s0 * a[3][C, C, C] - p[C, C, C]) * bnd[C, C, C]


def _np_gosa(ss):
    return float(np.sum(np.square(ss)))


def _np_update(p, ss):
    p = p.copy()
    p[1:-1, 1:-1, 1:-1] += OMEGA * ss
    return p


def _dev_stencil(p, a, b, c, bnd, wrk1):
    ss, _ = himeno_stencil(p, a, b, c, bnd, wrk1)
    return ss


def _dev_residual(p, a, b, c, bnd, wrk1):
    """final_residual on the device: the stencil entry's own gosa partials."""
    _, parts = himeno_stencil(p, a, b, c, bnd, wrk1)
    return torch.sum(parts)


def _dev_gosa(ss):
    return torch.sum(torch.square(ss))


def _dev_update(p, ss):
    # In place: p is the app's own array, held by nothing else. The product
    # and the sum round separately, as in _np_update.
    p[1:-1, 1:-1, 1:-1] += OMEGA * ss
    return p


@dataclass
class HimenoApp:
    """Executable Himeno with per-unit CPU/device placement.

    ``device=None`` runs the device units on the card and raises when there
    is none; tests pass ``device="cpu"``."""

    grid: tuple[int, int, int] = (17, 17, 33)
    iters: int = 4
    power: PaperPowerModel = field(default_factory=PaperPowerModel)
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    # ------------------------------------------------------------------
    def run(self, placement: dict[str, int], *, budget_s: Optional[float] = None
            ) -> Measurement:
        """placement: unit name -> 0 (CPU/NumPy) or 1 (device/PyTorch).

        Returns a Measurement with measured wall time and modeled energy."""
        t0 = time.perf_counter()
        t_device = 0.0
        i, j, k = self.grid
        device = self.device

        def on_dev(name):
            return bool(placement.get(name, 0))

        def timed(dev: bool, fn, *args):
            nonlocal t_device
            ts = time.perf_counter()
            out = fn(*args)
            if dev:
                if device.type == "cuda":  # t_device times finished work
                    torch.cuda.synchronize(device)
                t_device += time.perf_counter() - ts
            return out

        def to_dev(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device,
                                                               copy=True)

        def to_host(x):
            return x.to("cpu", copy=True).numpy()

        # --- init units (the paper's initmt loops) -------------------------
        shape = self.grid
        f32 = dict(dtype=torch.float32, device=device)

        def init_unit(name, np_fn, dev_fn):
            dev = on_dev(name)
            return timed(dev, dev_fn if dev else np_fn)

        kk = np.arange(k, dtype=np.float32)
        p = init_unit(
            "init_p",
            lambda: np.broadcast_to(((kk / (k - 1)) ** 2)[None, None, :],
                                    shape).copy(),
            lambda: ((torch.arange(k, **f32) / (k - 1)) ** 2
                     )[None, None, :].expand(shape).contiguous())
        a012 = init_unit("init_a012",
                         lambda: np.ones((3,) + shape, np.float32),
                         lambda: torch.ones((3,) + shape, **f32))
        a3 = init_unit("init_a3",
                       lambda: np.full(shape, 1.0 / 6.0, np.float32),
                       lambda: torch.full(shape, 1.0 / 6.0, **f32))
        b = init_unit("init_b",
                      lambda: np.zeros((3,) + shape, np.float32),
                      lambda: torch.zeros((3,) + shape, **f32))
        c = init_unit("init_c",
                      lambda: np.ones((3,) + shape, np.float32),
                      lambda: torch.ones((3,) + shape, **f32))
        bnd = init_unit("init_bnd",
                        lambda: np.ones(shape, np.float32),
                        lambda: torch.ones(shape, **f32))
        wrk1 = init_unit("init_wrk1",
                         lambda: np.zeros(shape, np.float32),
                         lambda: torch.zeros(shape, **f32))
        _ = init_unit("init_wrk2",
                      lambda: np.zeros(shape, np.float32),
                      lambda: torch.zeros(shape, **f32))

        def place(x, dev: bool):
            if dev and isinstance(x, np.ndarray):
                return to_dev(x)
            if not dev and isinstance(x, torch.Tensor):
                return to_host(x)
            return x

        # Built on the device whatever the placement, as the reference app
        # does, so the two apps time the same work.
        a_full_dev = torch.cat([place(a012, True), place(a3, True)[None]], 0)
        a_full_np = np.concatenate([place(a012, False),
                                    place(a3, False)[None]], 0)

        gosa = 0.0
        for _ in range(self.iters):
            if budget_s and time.perf_counter() - t0 > budget_s:
                # Truncated runs report through the same power path as
                # completed runs: real t_device so far, modeled energy and
                # average watts over the measured wall time — not a zero
                # energy that would make the timeout *cheaper* than running.
                t_total = time.perf_counter() - t0
                return Measurement(
                    time_s=t_total,
                    energy_ws=self.power.energy(t_total, t_device),
                    timed_out=True,
                    avg_watts=self.power.average_watts(t_total, t_device),
                    detail={"t_device": t_device,
                            "placement": dict(placement),
                            "truncated": True})
            # u8: stencil
            dev = on_dev("jacobi_stencil")
            p = place(p, dev)
            args = [place(x, dev) for x in
                    (a_full_dev if dev else a_full_np, b, c, bnd, wrk1)]
            ss = timed(dev, _dev_stencil if dev else _np_stencil, p, *args)
            # u9: gosa reduction
            dev = on_dev("gosa_reduction")
            ss_g = place(ss, dev)
            gosa = timed(dev, _dev_gosa if dev else _np_gosa, ss_g)
            # u10+u11: wrk2 write + p update (fused update, as in the python
            # himeno where wrk2 is copied back into p's interior)
            dev = on_dev("wrk2_write") or on_dev("p_update")
            p, ss = place(p, dev), place(ss, dev)
            p = timed(dev, _dev_update if dev else _np_update, p, ss)

        # u12: final residual
        dev = on_dev("final_residual")
        p = place(p, dev)
        args = [place(x, dev) for x in
                (a_full_dev if dev else a_full_np, b, c, bnd, wrk1)]
        if dev:
            final = timed(True, _dev_residual, p, *args)
        else:
            ss = timed(False, _np_stencil, p, *args)
            final = timed(False, _np_gosa, ss)

        t_total = time.perf_counter() - t0
        energy = self.power.energy(t_total, t_device)
        return Measurement(
            time_s=t_total, energy_ws=energy,
            avg_watts=self.power.average_watts(t_total, t_device),
            detail={"gosa": float(gosa), "final_residual": float(final),
                    "t_device": t_device, "placement": dict(placement),
                    "truncated": False})

    def verify_numerics(self) -> float:
        """|gosa_all_cpu - gosa_all_device| — placement must not change math."""
        cpu = self.run({u: 0 for u in UNIT_NAMES})
        dev = self.run({u: 1 for u in UNIT_NAMES})
        return abs(cpu.detail["gosa"] - dev.detail["gosa"])
