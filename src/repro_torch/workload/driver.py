"""Virtual-clock fleet simulation: open-loop arrivals meet real queueing.

``generate()`` (``workload/generator.py``) emits a timestamped request
trace; this driver replays it against a :class:`FleetRouter` on one
simulated clock, which is what makes the energy-proportional story
measurable at all:

* **real queueing pressure** — requests arrive when the trace says, not
  when an engine happens to be free. An engine mid-step cannot admit; the
  backlog builds, occupancy rises, completion latency (and therefore SLO
  compliance) becomes an *outcome* instead of an input.
* **modeled step durations** — each ``stream_step`` advances an engine's
  clock by the step's modeled duration (``ServingEngine.last_step_s``: the
  max per-token time across its active slots under their admission
  epochs), so heterogeneous destinations genuinely serve at different
  speeds.
* **idle accounting with no double-count** — for exactly the wall-clock
  intervals an engine did NOT step in, the driver charges the engine's
  current power state's static draw to ``EngineStats.idle_ws``
  (``accrue_idle``). Busy steps already carry the idle term inside their
  per-token rates; the union of "stepping" and "accrued idle" intervals
  tiles the simulated timeline exactly once.
* **autoscaling ticks** — at a fixed cadence the driver estimates token
  demand over a sliding arrival window and calls
  :meth:`FleetRouter.scale_to`; wake latencies then delay real admissions
  and show up as SLO violations if the fleet scaled down too eagerly.

Everything is deterministic: the trace is seeded, the event loop breaks
ties in binding order, and the modeled ledger never touches a wall clock —
the same trace against the same fleet reproduces the same
:class:`SimReport` field for field.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

from repro_torch.runtime.router import FleetRouter
from repro_torch.runtime.serving import EngineStats
from repro_torch.workload.generator import TimedRequest


@dataclass
class SimReport:
    """Everything one simulated serve produced (ledger fields are deltas
    over the simulation, so a reused router doesn't leak prior traffic)."""

    duration_s: float  # simulated horizon the idle ledger covers
    submitted: int
    completed: int
    rejected: int
    steps: int
    tokens: int  # prefill + decode tokens actually served
    energy_ws: float  # modeled serving energy (per-token rates)
    idle_ws: float  # static draw charged for non-stepping wall time
    slo_total: int  # submitted requests carrying an SLO
    slo_violations: int  # end-to-end completion later than slo_s
    # transfer cost of mid-flight slot migrations (bytes x link rate),
    # billed to receiving engines — on the full bill, so a migration-happy
    # policy cannot look cheap by hiding its moves
    migration_ws: float = 0.0
    migrations: int = 0  # slots moved mid-flight
    finish_s: dict[int, float] = field(default_factory=dict)  # rid -> t
    # (t, {engine: state}) every time an autoscaling tick changed anything
    power_log: list[tuple[float, dict[str, str]]] = field(default_factory=list)
    fleet: EngineStats = field(default_factory=EngineStats)

    @property
    def total_ws(self) -> float:
        """The full bill: serving energy plus static idle energy plus
        migration transfer cost."""
        return self.energy_ws + self.idle_ws + self.migration_ws

    @property
    def ws_per_1k_tokens(self) -> float:
        """The paper-style headline metric, on the FULL bill — an always-on
        fleet pays its idle floors here, which is the entire point."""
        return self.total_ws / self.tokens * 1000.0 if self.tokens else 0.0


def simulate(router: FleetRouter, trace: Sequence[TimedRequest], *,
             horizon_s: Optional[float] = None,
             autoscale_every_s: Optional[float] = None,
             rate_window_s: Optional[float] = None,
             plan_times: Sequence[float] = (),
             rebalance_every_s: Optional[float] = None,
             rebalance_live: bool = False,
             min_step_s: float = 1e-9,
             max_events: int = 2_000_000) -> SimReport:
    """Replay ``trace`` against ``router`` on a virtual clock.

    ``horizon_s`` extends the idle ledger (and autoscaling ticks) to a fixed
    end time even after the last request drains — always-on and autoscaled
    runs must be billed over the SAME wall span to compare fairly.
    ``autoscale_every_s`` enables control ticks: demand is the token sum of
    arrivals in the trailing ``rate_window_s`` (default 4 ticks) divided by
    the window. ``plan_times`` additionally runs full
    ``router.plan(now=t)`` passes at the given times.
    ``rebalance_every_s`` runs ``router.rebalance(include_saturated=True)``
    at a fixed cadence — queue-drain by default, escalated to mid-flight
    migration of admitted slots with ``rebalance_live=True``.
    ``min_step_s`` guards
    the clock against placement-less engines modeling zero-duration steps.
    """
    bindings = router.bindings
    base = {b.name: b.engine.stats.snapshot() for b in bindings}
    pending = deque(sorted(trace, key=lambda tr: (tr.at_s, tr.rid)))
    total_arrivals = len(pending)

    window = rate_window_s if rate_window_s is not None else \
        (4.0 * autoscale_every_s if autoscale_every_s else 1.0)
    arrivals: deque[tuple[float, int]] = deque()  # (t, token demand)
    next_tick = autoscale_every_s if autoscale_every_s else None
    next_reb = rebalance_every_s if rebalance_every_s else None
    plan_q = deque(sorted(plan_times))

    avail = {b.name: 0.0 for b in bindings}  # earliest next step start
    accrued_to = {b.name: 0.0 for b in bindings}  # idle ledger watermark
    finish_s: dict[int, float] = {}
    power_log: list[tuple[float, dict[str, str]]] = []
    last_states = router.power_states()
    submitted = rejected = steps = 0
    now = 0.0

    def next_step_time(b) -> Optional[float]:
        """When this engine could start its next step (None: no work)."""
        if not b.engine.stream_busy():
            return None
        t = max(avail[b.name], now)
        return t + b.engine.wake_penalty_s(t)

    for b in bindings:
        b.engine.stream_open()
    try:
        for _ in range(max_events):
            cands: list[float] = []
            if pending:
                cands.append(pending[0].at_s)
            busy = False
            for b in bindings:
                st = next_step_time(b)
                if st is not None:
                    busy = True
                    cands.append(st)
            has_work = bool(pending) or busy
            if next_tick is not None and (
                    has_work or (horizon_s is not None
                                 and next_tick <= horizon_s)):
                cands.append(next_tick)
            if next_reb is not None and has_work:
                cands.append(next_reb)
            if plan_q:
                cands.append(plan_q[0])
            if not cands:
                break
            now = max(now, min(cands))

            # idle accrual first: it covers time strictly BEFORE `now`,
            # under the power states held during that interval — events at
            # `now` (wakes, floors, steps) must not retroactively reprice it
            for b in bindings:
                dt = now - accrued_to[b.name]
                if dt > 0.0:
                    b.engine.accrue_idle(dt)
                    accrued_to[b.name] = now

            while pending and pending[0].at_s <= now:
                tr = pending.popleft()
                arrivals.append((tr.at_s, tr.tokens()))
                submitted += 1
                if not router.submit(tr.request, now=now):
                    rejected += 1
            while plan_q and plan_q[0] <= now:
                plan_q.popleft()
                router.plan(now=now)
            while next_tick is not None and next_tick <= now:
                cutoff = next_tick - window
                while arrivals and arrivals[0][0] <= cutoff:
                    arrivals.popleft()
                demand = sum(tok for _, tok in arrivals) / window
                if router.autoscale:
                    states = router.scale_to(demand, now)
                    if states != last_states:
                        power_log.append((now, dict(states)))
                        last_states = dict(states)
                next_tick += autoscale_every_s
            while next_reb is not None and next_reb <= now:
                router.rebalance(live=rebalance_live,
                                 include_saturated=True, now=now)
                next_reb += rebalance_every_s

            for b in bindings:
                eng = b.engine
                if not eng.stream_busy() or avail[b.name] > now:
                    continue
                if eng.power_state in ("floor", "asleep"):
                    eng.wake(now)  # defensive: work never waits on standby
                if not eng.check_awake(now):
                    continue
                finished = eng.stream_step()
                if finished is None:
                    continue
                steps += 1
                d = max(eng.last_step_s, min_step_s)
                avail[b.name] = now + d
                accrued_to[b.name] = now + d  # busy interval: billed by token
                for req in finished:
                    finish_s[req.rid] = now + d
        else:
            raise RuntimeError(f"simulation exceeded {max_events} events "
                               "without draining")
    finally:
        for b in bindings:
            b.engine.stream_close()

    end = max([now, horizon_s or 0.0] + list(avail.values()))
    for b in bindings:
        dt = end - accrued_to[b.name]
        if dt > 0.0:
            b.engine.accrue_idle(dt)
            accrued_to[b.name] = end

    fleet = EngineStats()
    for b in bindings:
        cur, b0 = b.engine.stats, base[b.name]
        for f in EngineStats.__dataclass_fields__:
            setattr(fleet, f,
                    getattr(fleet, f) + getattr(cur, f) - getattr(b0, f))

    slo_total = slo_violations = 0
    for tr in trace:
        req = tr.request
        if req.slo_s is None:
            continue
        slo_total += 1
        done_at = finish_s.get(req.rid)
        if done_at is None or done_at - tr.at_s > req.slo_s:
            slo_violations += 1  # unserved SLO traffic counts as violated

    assert submitted == total_arrivals
    return SimReport(duration_s=end, submitted=submitted,
                     completed=len(finish_s), rejected=rejected,
                     steps=steps, tokens=fleet.total_tokens,
                     energy_ws=fleet.energy_ws, idle_ws=fleet.idle_ws,
                     slo_total=slo_total, slo_violations=slo_violations,
                     migration_ws=fleet.migration_ws,
                     migrations=fleet.migrations_in,
                     finish_s=finish_s, power_log=power_log, fleet=fleet)
