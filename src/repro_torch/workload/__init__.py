"""Open-loop traffic generation + virtual-clock fleet simulation.

``generator`` emits seed-deterministic timestamped request traces
(Poisson/bursty arrivals, diurnal envelopes, heavy-tailed lengths,
multi-tenant SLO classes); ``driver`` replays a trace against a
:class:`~repro_torch.runtime.router.FleetRouter` on a simulated clock with
energy-proportional power-state accounting.
"""
from repro_torch.workload.driver import SimReport, simulate
from repro_torch.workload.forecast import TenantForecast, WorkloadForecast
from repro_torch.workload.generator import (
    ARRIVALS, TenantSpec, TimedRequest, WorkloadSpec, diurnal_mult,
    empirical_rate_rps, generate, mean_diurnal_mult, trace_bytes,
    trace_digest,
)

__all__ = [
    "ARRIVALS", "SimReport", "TenantForecast", "TenantSpec", "TimedRequest",
    "WorkloadForecast", "WorkloadSpec", "diurnal_mult", "empirical_rate_rps",
    "generate", "mean_diurnal_mult", "simulate", "trace_bytes",
    "trace_digest",
]
