"""The paper's workload as an executable app with per-unit placement."""
from repro_torch.apps.himeno_app import LOOP_UNITS, UNIT_NAMES, HimenoApp

__all__ = ["LOOP_UNITS", "UNIT_NAMES", "HimenoApp"]
