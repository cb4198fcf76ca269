"""Serving runtime of the port: the slot-stream / wave engine."""
from repro_torch.runtime.serving import (
    EngineStats, Placement, Request, ServingEngine,
)

__all__ = ["EngineStats", "Placement", "Request", "ServingEngine"]
