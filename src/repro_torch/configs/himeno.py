"""The paper's own workload: Himeno benchmark grid presets (RIKEN sizes).

Not an LM ArchConfig — the Himeno app has its own 13-unit offload structure
(apps/himeno_app.py); this module just centralizes the standard problem
sizes so benchmarks/tests/examples agree with the paper's §4 ("Large":
512×256×256).
"""
from __future__ import annotations

GRIDS: dict[str, tuple[int, int, int]] = {
    "S": (64, 64, 128),
    "M": (128, 128, 256),
    "L": (512, 256, 256),   # the paper's evaluation size
    "XL": (1024, 512, 512),
    # CPU-test sizes
    "tiny": (17, 17, 33),
    "small": (33, 33, 65),
}

PAPER_GRID = GRIDS["L"]
PAPER_ITERS = 62  # calibrated so the all-CPU run costs the paper's 153 s
