"""Static arithmetic-intensity analysis — the ROSE-framework analogue (§3.2).

Per-offload-unit FLOPs / device-memory bytes / trip counts / working-set
("resource") estimates from the workload model alone. This port carries the
Himeno half (``UnitCost``, ``himeno_unit_costs``), which the calibrated
verifier backend builds its unit times from.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class UnitCost:
    name: str
    flops: float            # per single execution of the unit
    hbm_bytes: float        # per single execution (reads + writes)
    trip_count: int         # executions per step (gcov/gprof analogue)
    vmem_bytes: float = 0.0  # working set a kernel must hold (FF/LUT analogue)
    parallel: bool = True   # a compiler could offload this (paper Step 2)

    @property
    def intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)

    @property
    def total_flops(self) -> float:
        return self.flops * self.trip_count

    @property
    def total_bytes(self) -> float:
        return self.hbm_bytes * self.trip_count


# ---------------------------------------------------------------------------
# Himeno workload model (per sweep over an (I,J,K) grid)
# ---------------------------------------------------------------------------


def himeno_unit_costs(grid: tuple[int, int, int], iters: int = 1
                      ) -> list[UnitCost]:
    i, j, k = grid
    pts = float(i * j * k)
    interior = float((i - 2) * (j - 2) * (k - 2))
    b4 = 4.0  # f32
    init = lambda name, arrs: UnitCost(name, pts, arrs * pts * b4, 1)
    units = [
        init("init_p", 1),
        init("init_a012", 3),
        init("init_a3", 1),
        init("init_b", 3),
        init("init_c", 3),
        init("init_bnd", 1),
        init("init_wrk1", 1),
        init("init_wrk2", 1),
        # hot loop: 34 FLOPs/point, reads p(19-pt reuse≈1 stream)+11 coef arrays
        UnitCost("jacobi_stencil", 34 * interior, 13 * pts * b4, iters,
                 vmem_bytes=15 * j * k * b4),
        UnitCost("gosa_reduction", 2 * interior, interior * b4, iters,
                 vmem_bytes=j * k * b4),
        UnitCost("wrk2_write", 2 * interior, 2 * interior * b4, iters,
                 vmem_bytes=2 * j * k * b4),
        UnitCost("p_update", 0.0, 2 * interior * b4, iters,
                 vmem_bytes=2 * j * k * b4),
        UnitCost("final_residual", 2 * interior, interior * b4, 1),
    ]
    return units
