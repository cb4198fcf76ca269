"""Serving runtime of the port: the slot-stream / wave engine, mid-flight
slot migration, the traffic-adaptive placement controller, and the fleet
above them (router, lockstep executor, fault tolerance)."""
from repro_torch.runtime.executor import FleetExecutor
from repro_torch.runtime.fault_tolerance import (
    ElasticOrchestrator, HeartbeatMonitor, StragglerDetector,
)
from repro_torch.runtime.migration import (
    MigrationError, SlotSnapshot, migrate, restore_slot, snapshot_slot,
)
from repro_torch.runtime.serving import (
    EngineStats, Placement, Request, ServingEngine,
)
from repro_torch.runtime.placement import (
    PlacementController, PlanReport, TrafficMix, static_placements,
)
from repro_torch.runtime.router import (
    EngineBinding, FleetRouter, RouterPlanReport,
)

__all__ = [
    "FleetExecutor",
    "ElasticOrchestrator", "HeartbeatMonitor", "StragglerDetector",
    "MigrationError", "SlotSnapshot", "migrate", "restore_slot",
    "snapshot_slot",
    "EngineStats", "Placement", "Request", "ServingEngine",
    "PlacementController", "PlanReport", "TrafficMix", "static_placements",
    "EngineBinding", "FleetRouter", "RouterPlanReport",
]
