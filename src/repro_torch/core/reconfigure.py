"""Step-7 運用中再構成 — runtime reconfiguration policy.

The environment-adaptive flow doesn't end at deployment: the paper's Step 7
re-adapts when the environment changes. Here that means reacting to node
failures / persistent stragglers / SLA drift on a TPU fleet:

  degraded mesh  -> re-shard from checkpoint onto the surviving slice
  SLA violation  -> re-run the offload search (GA) for the new topology
  recovered      -> scale back up

Pure-policy module: the runtime (runtime/fault_tolerance.py) feeds events,
this decides; decisions are executed by the launcher.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.fitness import Measurement, UserRequirement


@dataclass(frozen=True)
class ClusterState:
    healthy_chips: int
    total_chips: int
    step_time_s: float
    sla: Optional[UserRequirement] = None


@dataclass(frozen=True)
class Action:
    kind: str  # continue | rescale | research | restore
    target_chips: int = 0
    reason: str = ""


@dataclass
class ReconfigurePolicy:
    """Hysteresis-based reconfiguration decisions."""

    min_healthy_fraction: float = 0.95
    sla_violation_patience: int = 3
    _violations: int = field(default=0, repr=False)

    def largest_valid_slice(self, chips: int, model_parallel: int = 16) -> int:
        """Largest chip count <= chips that keeps the (data, model) mesh
        well-formed (multiple of the model axis, power-of-two data axis)."""
        data = chips // model_parallel
        if data < 1:
            return 0
        data = 2 ** int(math.floor(math.log2(data)))
        return data * model_parallel

    def decide(self, state: ClusterState) -> Action:
        if state.healthy_chips < state.total_chips * self.min_healthy_fraction:
            target = self.largest_valid_slice(state.healthy_chips)
            if target <= 0:
                return Action("continue", reason="no valid degraded mesh; halt")
            return Action("rescale", target_chips=target,
                          reason=f"{state.total_chips - state.healthy_chips} "
                                 "chips unhealthy; re-shard from checkpoint")
        if state.sla is not None:
            meas = Measurement(time_s=state.step_time_s, energy_ws=1.0)
            if not state.sla.satisfied(meas):
                self._violations += 1
                if self._violations >= self.sla_violation_patience:
                    self._violations = 0
                    return Action("research", target_chips=state.healthy_chips,
                                  reason="persistent SLA violation; re-run "
                                         "offload search for current topology")
            else:
                self._violations = 0
        if (state.healthy_chips == state.total_chips
                and state.step_time_s > 0):
            return Action("continue")
        return Action("continue")
