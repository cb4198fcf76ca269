"""Serving runtime of the port: the slot-stream / wave engine, mid-flight
slot migration and the traffic-adaptive placement controller."""
from repro_torch.runtime.migration import (
    MigrationError, SlotSnapshot, migrate, restore_slot, snapshot_slot,
)
from repro_torch.runtime.serving import (
    EngineStats, Placement, Request, ServingEngine,
)
from repro_torch.runtime.placement import (
    PlacementController, PlanReport, TrafficMix, static_placements,
)

__all__ = [
    "MigrationError", "SlotSnapshot", "migrate", "restore_slot",
    "snapshot_slot",
    "EngineStats", "Placement", "Request", "ServingEngine",
    "PlacementController", "PlanReport", "TrafficMix", "static_placements",
]
