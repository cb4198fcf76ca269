"""Lockstep concurrent fleet executor: N engines, one barrier per tick.

``FleetRouter.run`` drained engines sequentially — wall-clock fleet time was
Σ(per-engine time) even though the engines share nothing but the read-only
model. This module makes the fleet step concurrently while staying
**token-identical and ledger-identical** to the sequential drain, which is
what lets every fleet invariant (fleet ledger == Σ engine ledgers,
deterministic resim) survive the threads.

Correctness argument (the one the JAX package's ``analysis/concurrency.py``
certifies over the same schedule):

* **Partitioned ownership.** Each engine is stepped by at most one worker
  at any moment: every tick submits at most one ``stream_step`` per engine
  and the tick barrier joins them all before the next tick begins. All
  engine state (``stats``, ``queue``, slot cursors, decode buffers) is
  therefore single-writer — the race lint's documented contract on
  :class:`~repro_torch.runtime.serving.ServingEngine`.
* **Barrier happens-before.** ``Future.result()`` provides the
  happens-before edge between a worker's writes and the coordinator's
  reads, and the coordinator's submissions order tick t's writes before
  tick t+1's reads. No engine attribute needs a lock.
* **Identical per-engine schedules.** A stream engine's life under the
  executor is the same call sequence ``stream_open``, ``stream_step`` (until
  exhausted or budget), ``stream_close`` that the sequential
  ``ServingEngine.run`` makes — only interleaved *across* engines, which no
  engine can observe (nothing is shared). Outputs, finish reasons and every
  ledger field are byte-identical to the sequential drain's.

No device dwell: the reference emulates the paper's offload round-trip
with an optional per-step sleep (``dwell_s``) that the concurrent drain
overlaps across destinations. The port has the device itself, so the wait
is real and the option is gone. Every engine launches on the device's
current stream, and a step ends in one host sync (the argmax's copy to the
host), which releases the GIL while the card works, so one engine's Python
overlaps another's device time.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

from repro_torch.runtime.serving import Request


class FleetExecutor:
    """Steps a fleet of
    :class:`~repro_torch.runtime.router.EngineBinding`\\ s on a thread
    pool, one lockstep tick at a time.

    ``max_workers`` defaults to the fleet size (every engine can be
    in-flight each tick). ``max_workers=1`` degenerates to the sequential schedule through
    the identical code path — the bench's like-for-like baseline.
    """

    def __init__(self, bindings: Sequence, *,
                 max_workers: Optional[int] = None,
                 on_tick=None) -> None:
        if not bindings:
            raise ValueError("need at least one engine binding")
        self.bindings = list(bindings)
        self.max_workers = max_workers or len(self.bindings)
        # coordinator-thread hook, called with the tick index after every
        # barrier — the single moment no worker holds any engine, so
        # cross-engine surgery (mid-flight migration, live rebalance) is
        # race-free by schedule: the barrier orders the workers' writes
        # before the hook's reads, and the hook's writes before the next
        # tick's submissions. Engines the hook hands new work (a restored
        # slot, a woken target) re-enter the live set on the next tick.
        self.on_tick = on_tick
        self.ticks = 0  # lockstep barriers crossed by the last run()

    def _step_engine(self, binding) -> Optional[list]:
        """One engine step on a worker thread (the lint's thread entry
        point). Touches only ``binding.engine`` — the partitioned-ownership
        contract: no two workers hold the same binding within a tick."""
        return binding.engine.stream_step()

    def run(self, max_waves: int = 64,
            max_steps: Optional[int] = None) -> list[Request]:
        """Drain every engine concurrently; returns finished requests in
        the sequential drain's order (engine binding order, completion
        order within an engine). Budget semantics match
        :meth:`~repro_torch.runtime.serving.ServingEngine.run`: per-engine
        ``max_steps`` steps (default ``max_waves * max_len``); wave-mode
        engines run whole on a worker each (their scheduler has no
        single-step surface, but they share nothing either)."""
        stream = [b for b in self.bindings
                  if b.engine.scheduler == "stream"]
        waves = [b for b in self.bindings if b.engine.scheduler != "stream"]
        self.ticks = 0
        done_by: dict[str, list[Request]] = {b.name: [] for b in self.bindings}
        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            wave_futs = [(b, pool.submit(b.engine.run, max_waves, max_steps))
                         for b in waves]
            if stream:
                budgets = {b.name: (max_steps if max_steps is not None
                                    else max_waves * b.engine.max_len)
                           for b in stream}
                for b in stream:
                    b.engine.stream_open()
                live = list(stream)
                try:
                    while live:
                        # one lockstep tick: at most one in-flight step per
                        # engine; gathering the futures is the barrier that
                        # orders this tick's writes before the next tick
                        futs = [(b, pool.submit(self._step_engine, b))
                                for b in live]
                        self.ticks += 1
                        nxt = []
                        for b, fut in futs:
                            finished = fut.result()
                            if finished is None:  # exhausted (or not awake)
                                continue
                            done_by[b.name].extend(finished)
                            budgets[b.name] -= 1
                            if budgets[b.name] > 0:
                                nxt.append(b)
                        live = nxt
                        if self.on_tick is not None:
                            self.on_tick(self.ticks)
                            # revival: the hook may have migrated a slot
                            # into (or woken) an engine that had idled out
                            # of the live set — an awake engine with slot
                            # or queue work and budget re-enters the
                            # lockstep. Without a hook nothing can touch a
                            # dropped engine, so this is unreachable and
                            # the schedule is byte-identical to the
                            # hook-less one.
                            in_live = {b.name for b in live}
                            for b in stream:
                                if (b.name not in in_live
                                        and budgets[b.name] > 0
                                        and b.engine.power_state == "awake"
                                        and b.engine.stream_busy()):
                                    live.append(b)
                finally:
                    for b in stream:
                        b.engine.stream_close()
            for b, fut in wave_futs:
                done_by[b.name].extend(fut.result())
        return [r for b in self.bindings for r in done_by[b.name]]
