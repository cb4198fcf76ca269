"""Budgeted fleet provisioning: search which destinations to *build*.

Capacity planning one level above ``search_fleet``: price every
destination type with the per-cell GA + Pareto operating points (shared
persistent eval cache, measurement pre-screen), then search the multiset
space of destination counts under a watt/area :class:`Budget`, maximizing
served tokens/s against a
:class:`~repro_torch.workload.forecast.WorkloadForecast` with the full
power-state bill (idle floors of over-provisioned engines included).
``cost_of_capacity_frontier`` sweeps ascending budgets into the
tokens/s-vs-provisioned-watts curve.
"""
from repro_torch.provision.budget import Budget
from repro_torch.provision.planner import (
    PROVISION_KINDS, DestinationEconomics, EconomicsResult, FleetEvaluation,
    FleetGenome, FrontierPoint, KindRate, ProvisionResult, SearchPolicy,
    cost_of_capacity_frontier, destination_economics, evaluate_fleet,
    plan_fleet,
)

__all__ = [
    "Budget", "DestinationEconomics", "EconomicsResult", "FleetEvaluation",
    "FleetGenome", "FrontierPoint", "KindRate", "PROVISION_KINDS",
    "ProvisionResult", "SearchPolicy", "cost_of_capacity_frontier",
    "destination_economics", "evaluate_fleet", "plan_fleet",
]
