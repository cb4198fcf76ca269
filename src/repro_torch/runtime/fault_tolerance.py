"""Fleet fault tolerance: heartbeat failure detection, straggler mitigation,
elastic rescale orchestration.

Event-driven and clock-injectable (tests drive a fake clock). The policy
decisions come from core.reconfigure (the paper's Step-7 runtime
reconfiguration); this module detects and orchestrates:

  heartbeat miss  -> node marked suspect -> failed after `grace`
  failure         -> ReconfigurePolicy.rescale -> restore checkpoint on the
                     largest valid sub-mesh, resume from last step
  straggler       -> per-step duration outliers -> deadline-based backup
                     dispatch (duplicate the slowest shard's work)
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.reconfigure import (
    Action, ClusterState, ReconfigurePolicy,
)


@dataclass
class NodeState:
    last_heartbeat: float = 0.0
    healthy: bool = True


@dataclass
class HeartbeatMonitor:
    num_nodes: int
    interval_s: float = 10.0
    grace_intervals: int = 3
    nodes: dict[int, NodeState] = field(default_factory=dict)

    def __post_init__(self):
        for i in range(self.num_nodes):
            self.nodes[i] = NodeState()

    def beat(self, node: int, now: float) -> None:
        st = self.nodes[node]
        st.last_heartbeat = now
        st.healthy = True

    def sweep(self, now: float) -> list[int]:
        """Returns newly-failed node ids."""
        failed = []
        horizon = self.interval_s * self.grace_intervals
        for i, st in self.nodes.items():
            if st.healthy and now - st.last_heartbeat > horizon:
                st.healthy = False
                failed.append(i)
        return failed

    def healthy_count(self) -> int:
        return sum(1 for st in self.nodes.values() if st.healthy)


@dataclass
class StragglerDetector:
    """Flags shards whose step times are persistent outliers."""

    window: int = 16
    threshold: float = 1.5  # x median
    patience: int = 3
    _times: dict[int, list[float]] = field(default_factory=dict)
    _strikes: dict[int, int] = field(default_factory=dict)

    def record(self, shard: int, step_time_s: float) -> None:
        hist = self._times.setdefault(shard, [])
        hist.append(step_time_s)
        if len(hist) > self.window:
            hist.pop(0)

    def stragglers(self) -> list[int]:
        med_all = [t for hist in self._times.values() for t in hist]
        if len(med_all) < 4:
            return []
        med = statistics.median(med_all)
        out = []
        for shard, hist in self._times.items():
            if hist and hist[-1] > self.threshold * med:
                self._strikes[shard] = self._strikes.get(shard, 0) + 1
            else:
                self._strikes[shard] = 0
            if self._strikes.get(shard, 0) >= self.patience:
                out.append(shard)
        return out

    def backup_deadline(self) -> float:
        """Deadline after which a backup duplicate of the slow shard's step
        is dispatched (speculative execution for the synchronous collective)."""
        med_all = [t for hist in self._times.values() for t in hist]
        return self.threshold * statistics.median(med_all) if med_all else 0.0


@dataclass
class ElasticOrchestrator:
    """Ties monitor + policy + checkpoint restore into a resume plan."""

    total_chips: int
    chips_per_node: int
    policy: ReconfigurePolicy = field(default_factory=ReconfigurePolicy)
    model_parallel: int = 16

    def plan(self, monitor: HeartbeatMonitor, step_time_s: float) -> Action:
        healthy_chips = monitor.healthy_count() * self.chips_per_node
        state = ClusterState(
            healthy_chips=healthy_chips,
            total_chips=self.total_chips,
            step_time_s=step_time_s)
        action = self.policy.decide(state)
        if action.kind == "rescale":
            target = self.policy.largest_valid_slice(
                healthy_chips, self.model_parallel)
            return Action("rescale", target_chips=target, reason=action.reason)
        return action

    def degraded_mesh_shape(self, target_chips: int) -> dict[str, int]:
        model = self.model_parallel
        data = max(target_chips // model, 1)
        return {"data": data, "model": model}
