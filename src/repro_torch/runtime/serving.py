"""Batched serving loop — slot-stream continuous batching (default) with the
legacy wave scheduler kept behind ``scheduler="wave"``.

Counterpart of the JAX package's ``runtime/serving.py``, dense family. The
schedulers, power states, ``reconfigure`` and the energy, idle and SLO
ledgers are the reference's, line for line. What differs: the engine holds
a ``TransformerLM`` and a ``device`` (None: the card; the model must lie
there), and its step is an eager ``decode_step`` that **updates the decode
state in place** — each layer's new K/V rows are written by index assignment
into the existing cache tensors — where the reference jits the step and
donates the state buffer. The per-step argmax stays one host sync a step.
``snapshot_slot``/``restore_slot`` (mid-flight migration) wait for slice 3;
placements come from the caller, since ``runtime/placement.py`` waits for
slice 4.

**Slot streams** (``scheduler="stream"``): each of the B slots carries its own
position stream inside one shared decode state (``models/transformer.py``
grew per-slot positions + ``reset_decode_slots``). A slot admits the next
queued request the step after its previous occupant finishes: the freed slot
is masked-reset (position back to 0, recurrent state re-initialized) while
its neighbors keep decoding, so cache positions never alias across the
requests sharing a slot — exactness is preserved for all architecture
families, and for any fixed request set the decoded outputs are
token-identical to the wave scheduler's. Prompts are still fed
token-by-token ("prefill-as-decode" — exact for every family, incl.
SSM/hybrid, since the decode step IS the recurrence).

**Waves** (``scheduler="wave"``): requests are admitted in waves of up to B
slots sharing one fresh decode state; finished slots idle out until the
whole wave drains. This is the pre-slot-stream design, retained so existing
comparisons stay reproducible — the occupancy it leaves on the table on
ragged-length traffic is exactly what ``benchmarks/serving_bench.py``'s
ragged scenario measures.

Placement integration: the engine carries per-shape-kind :class:`Placement`
records (chosen by ``runtime/placement.py`` from fleet Pareto frontiers)
whose per-token energy rates accumulate into ``EngineStats.energy_ws`` —
the modeled Watt·s the offload search is minimizing, attributed to live
traffic. Every token is costed under the **placement epoch active at its
slot's admission**: ``reconfigure`` applies to newly admitted slots, so a
mid-stream swap never re-prices in-flight requests (in wave mode this
degenerates to the old "reconfigure only between waves" rule, which
``reconfigure`` still enforces there). ``Placement.time_per_token_s``
additionally makes admission placement-aware: each admitted request gets a
modeled completion latency, checked against its optional ``slo_s`` and
exported to the controller (``slo_time_per_step_s``) so latency SLOs join
energy in the §3.3 narrowing.

Hooks: ``on_step_end`` fires after every stream step (the controller's
step-count observation window); ``on_wave_end`` fires after each wave in
wave mode.

**Power states** (energy-proportional serving): an engine is ``awake``
(full static draw, serves), at the DVFS ``floor`` (reduced static draw,
retains state, near-instant wake — cannot step), ``asleep`` (retention
draw only, slow wake — never admits, never bills a token) or ``waking``
(paying the wake latency; full draw, cannot step yet). Static watts per
state come from the destination's ``TpuPowerModel`` idle floor
(``set_power``); :meth:`accrue_idle` charges them to the separate
``EngineStats.idle_ws`` ledger — *separate* because the per-token energy
rates already fold the idle term in during busy steps, so wall-clock static
draw is only charged for the time an engine is NOT stepping. The fleet
router spins these states with observed traffic (``FleetRouter.scale_to``)
and the workload driver (``workload/driver.py``) advances the clock.

**Stream sessions**: ``stream_open`` / ``stream_step`` / ``stream_close``
expose the slot-stream loop one step at a time, so a simulator can
interleave open-loop arrivals, power transitions and engine steps on one
virtual clock. ``run()`` is implemented on top of them and stays
token-identical to the pre-session loop.

"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    slo_s: Optional[float] = None  # completion-latency SLO (modeled)
    output: list[int] = field(default_factory=list)
    done: bool = False
    # queued -> active -> done; "rejected" (never admitted) and "truncated"
    # (admitted with a shortened prompt) are marked explicitly so callers
    # never mistake an unserved or clipped request for a clean completion.
    status: str = "queued"
    # why the request stopped: "eos" | "max_new_tokens" | "length_cap".
    # A length_cap finish reached neither eos nor max_new_tokens — the cache
    # ran out; pre-PR-4 this was silently indistinguishable from a clean
    # finish.
    finish_reason: Optional[str] = None
    truncated_tokens: int = 0  # prompt tokens dropped by the truncate policy
    # placement-modeled completion latency, stamped at admission from the
    # slot's placement epoch (prefill steps + decode steps at the epoch's
    # time_per_token_s rates)
    modeled_latency_s: float = 0.0
    # serving attribution, stamped at admission: which engine took the
    # request and which offload destination its placement epoch billed it
    # to — the fleet router's per-request routing record, and what the
    # serve CLI reports per request
    served_by: Optional[str] = None
    destination: Optional[str] = None


@dataclass
class EngineStats:
    steps: int = 0
    waves: int = 0  # wave scheduler only; 0 under slot streams
    admissions: int = 0  # requests admitted into a slot
    prefill_tokens: int = 0
    decode_tokens: int = 0
    completed: int = 0
    length_capped: int = 0  # finishes forced by the cache filling up
    slo_at_risk: int = 0  # admissions whose modeled latency exceeds slo_s
    rejected: int = 0  # refused at submit (prompt cannot fit max_len)
    truncated: int = 0  # admitted with a clipped prompt
    incomplete: int = 0  # step/wave budget exhausted before completion
    slot_steps: int = 0  # slots x steps: the occupancy denominator
    active_slot_steps: int = 0  # slots actually decoding a request
    energy_ws: float = 0.0  # modeled Watt·s under the applied placements
    # static Watt·s charged for wall-clock time spent NOT stepping (awake
    # gaps, floor, asleep, waking) — the idle power the paper's fleet-scale
    # claim needs on the ledger; busy steps already carry the idle term
    # inside their per-token rates, so the two never double-count
    idle_ws: float = 0.0
    idle_s: float = 0.0  # seconds the static draw was charged for
    wakes: int = 0  # asleep/floor -> awake transitions
    sleeps: int = 0  # awake/floor -> asleep transitions
    reconfigurations: int = 0
    migrations_in: int = 0  # live slots restored into this engine
    migrations_out: int = 0  # live slots snapshotted away mid-flight
    # transfer-cost ledger line: Watt·s billed for moving slot snapshots
    # INTO this engine (snapshot bytes x the link's Ws/MiB). Kept separate
    # from energy_ws so serving energy stays attributable to tokens — a
    # migrated request's tokens bill once (pre-move under the source epoch,
    # post-move under the target's) and the move itself bills here.
    migration_ws: float = 0.0

    @property
    def occupancy(self) -> float:
        """Mean fraction of batch slots doing useful work."""
        return self.active_slot_steps / self.slot_steps if self.slot_steps \
            else 0.0

    @property
    def total_tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens

    @property
    def total_ws(self) -> float:
        """Serving energy plus static idle energy plus migration transfer
        cost — the full fleet bill."""
        return self.energy_ws + self.idle_ws + self.migration_ws

    def snapshot(self) -> "EngineStats":
        return EngineStats(**{f: getattr(self, f)
                              for f in self.__dataclass_fields__})


@dataclass(frozen=True)
class Placement:
    """One applied (cell, destination, operating point) choice for a shape
    kind. ``energy_per_token_ws``/``time_per_token_s`` are the chosen
    pattern's measurement normalized by the cell's tokens-per-step, so the
    serving loop can integrate modeled energy over live traffic and model
    per-request completion latency for SLO-aware admission."""

    kind: str  # "prefill" | "decode"
    cell: str  # fleet cell key the pattern was searched in
    destination: str  # chosen offload destination (mesh label)
    decisions: object  # core.lm_cost_model.Decisions (kept opaque here)
    clock: float  # DVFS operating point (1.0 = nominal)
    energy_per_token_ws: float
    time_per_token_s: float = 0.0
    source: str = "static"  # static | adaptive


POWER_STATES = ("awake", "floor", "asleep", "waking")


class ServingEngine:
    """Greedy decoding over ``decode_step`` with slot-stream continuous
    batching (``scheduler="stream"``, default) or wave batching
    (``scheduler="wave"``).

    ``overflow`` is the admission policy for prompts that cannot leave room
    for a single generated token within ``max_len``:

    * ``"reject"``   — refuse at ``submit`` (marked ``rejected``, counted in
      ``stats.rejected``, never queued).
    * ``"truncate"`` — keep the prompt head (reserving the token budget),
      mark the request ``truncated`` and serve it.

    Thread-safety: single-writer. An engine instance is owned by exactly
    one thread at any moment; nothing here is locked, by design — the hot
    decode path must not pay lock traffic for its own ``stats``/``queue``.
    """

    def __init__(self, cfg: ArchConfig, model, *, slots: int = 4,
                 max_len: int = 256, overflow: str = "reject",
                 scheduler: str = "stream", name: str = "engine",
                 device=None):
        if overflow not in ("reject", "truncate"):
            raise ValueError(f"unknown overflow policy {overflow!r}")
        if scheduler not in ("stream", "wave"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        self.device = resolve_device(device)
        if model is not None:
            where = next(model.parameters()).device
            if where.type != self.device.type or (
                    where.index is not None and self.device.index is not None
                    and where.index != self.device.index):
                raise ValueError(f"the model lies on {where}, the engine "
                                 f"serves on {self.device}")
        self.cfg = cfg
        self.model = model
        self.name = name  # serving-attribution label (fleet router names us)
        self.slots = slots
        self.max_len = max_len
        self.overflow = overflow
        self.scheduler = scheduler
        self.queue: deque[Request] = deque()
        self.rejected: list[Request] = []
        self.active: list[Request] = []  # currently admitted, not finished
        self.stats = EngineStats()
        self.placements: dict[str, Placement] = {}
        # Metered calibration of the energy ledger: per-kind multiplicative
        # corrections (metered / modeled Watt·s per token) applied by
        # PlacementController.note_metered when telemetry disagrees with the
        # model. 1.0 (absent) = trust the model. Corrections are live
        # calibration state, so they apply across placement epochs.
        self.energy_correction: dict[str, float] = {}
        self.on_wave_end: Optional[Callable[["ServingEngine"], None]] = None
        self.on_step_end: Optional[Callable[["ServingEngine"], None]] = None
        self._in_wave = False
        # power state machine (energy-proportional serving). Watts default
        # to 0.0 so legacy paths that never call set_power/accrue_idle keep
        # a byte-identical ledger.
        self.power_state = "awake"
        self.idle_watts = 0.0  # awake static draw (p_idle x chips)
        self.floor_watts = 0.0  # DVFS-floor standby draw
        self.sleep_watts = 0.0  # deep-sleep retention draw
        self.wake_s = 0.0  # asleep -> awake latency
        self.floor_wake_s = 0.0  # floor -> awake latency (near-instant)
        self._awake_at = 0.0  # when a "waking" engine finishes waking
        self._stream: Optional[dict] = None  # open stream session state
        self._wave: Optional[dict] = None  # open wave session state
        self.last_step_s = 0.0  # modeled duration of the last stream step
        # decode_step writes the new K/V rows into the state's cache tensors
        # and returns the same state: the in-place update the reference gets
        # from a jit that donates the state, without a copy or a second
        # cache-sized buffer per token.
        self._step = lambda model, state, tokens: T.decode_step(
            cfg, model, state, tokens)

    def submit(self, req: Request) -> bool:
        """Admit a request; False when rejected (empty prompt, a prompt the
        overflow policy refuses, or the engine being asleep — a sleeping
        engine never admits)."""
        if self.power_state == "asleep":
            req.status = "rejected"
            self.stats.rejected += 1
            self.rejected.append(req)
            return False
        if not req.prompt:  # nothing to condition on; truncation can't help
            req.status = "rejected"
            self.stats.rejected += 1
            self.rejected.append(req)
            return False
        if len(req.prompt) >= self.max_len:  # no room for a generated token
            if self.overflow == "reject":
                req.status = "rejected"
                self.stats.rejected += 1
                self.rejected.append(req)
                return False
            keep = max(1, self.max_len - max(req.max_new_tokens, 1))
            req.truncated_tokens = len(req.prompt) - keep
            req.prompt = req.prompt[:keep]
            req.status = "truncated"
            self.stats.truncated += 1
        self.queue.append(req)
        return True

    # ------------------------------------------------------------------
    # Power states (energy-proportional serving)
    # ------------------------------------------------------------------
    def set_power(self, *, idle_watts: float, floor_frac: float = 0.4,
                  sleep_frac: float = 0.05, wake_s: float = 0.0,
                  floor_wake_s: float = 0.0) -> None:
        """Install the destination's static power levels: ``idle_watts`` is
        the awake floor (the power model's ``p_idle`` x chips — exactly the
        term the meter's idle-baseline subtraction quantifies), the floor
        and sleep states draw the given fractions of it, and waking from
        deep sleep costs ``wake_s`` seconds (``floor_wake_s`` from the DVFS
        floor)."""
        if idle_watts < 0.0 or wake_s < 0.0 or floor_wake_s < 0.0:
            raise ValueError("watts and wake latencies must be nonnegative")
        self.idle_watts = idle_watts
        self.floor_watts = idle_watts * floor_frac
        self.sleep_watts = idle_watts * sleep_frac
        self.wake_s = wake_s
        self.floor_wake_s = floor_wake_s

    def static_watts(self) -> float:
        """Static draw of the current power state (what one second of NOT
        stepping costs). A waking engine already burns the full awake floor
        — spin-up is not free."""
        if self.power_state == "asleep":
            return self.sleep_watts
        if self.power_state == "floor":
            return self.floor_watts
        return self.idle_watts  # awake | waking

    @property
    def idle(self) -> bool:
        """No queued and no admitted-unfinished work."""
        return not self.queue and not self.active

    def sleep(self) -> None:
        """awake/floor -> asleep. Only an *idle* engine may sleep: queued or
        in-flight requests pin it awake (the router drains first)."""
        if self.power_state == "asleep":
            return
        if not self.idle:
            raise RuntimeError("cannot sleep with queued or in-flight "
                               "requests")
        self.power_state = "asleep"
        self.stats.sleeps += 1

    def to_floor(self) -> None:
        """awake -> floor (DVFS-floor standby: reduced static draw, state
        retained, near-instant wake). Requires idleness like sleep — the
        floor cannot step."""
        if self.power_state == "floor":
            return
        if self.power_state != "awake":
            raise RuntimeError(f"to_floor from {self.power_state!r}")
        if not self.idle:
            raise RuntimeError("cannot drop to the floor with queued or "
                               "in-flight requests")
        self.power_state = "floor"

    def wake(self, now: float) -> float:
        """Start (or finish) waking; returns the time the engine is awake.
        Waking from the DVFS floor costs ``floor_wake_s``, from deep sleep
        ``wake_s``; an awake engine returns ``now`` unchanged."""
        if self.power_state == "awake":
            return now
        if self.power_state == "waking":
            return self._awake_at
        latency = (self.floor_wake_s if self.power_state == "floor"
                   else self.wake_s)
        self.stats.wakes += 1
        if latency <= 0.0:
            self.power_state = "awake"
            self._awake_at = now
            return now
        self.power_state = "waking"
        self._awake_at = now + latency
        return self._awake_at

    def check_awake(self, now: float) -> bool:
        """Complete a pending wake whose latency has elapsed; True when the
        engine is awake (can step) at ``now``."""
        if self.power_state == "waking" and now >= self._awake_at:
            self.power_state = "awake"
        return self.power_state == "awake"

    def wake_penalty_s(self, now: float) -> float:
        """Seconds before this engine could serve a request routed at
        ``now`` — what SLO-aware routing charges a spun-down destination."""
        if self.power_state == "awake":
            return 0.0
        if self.power_state == "waking":
            return max(self._awake_at - now, 0.0)
        if self.power_state == "floor":
            return self.floor_wake_s
        return self.wake_s

    def accrue_idle(self, dt: float) -> float:
        """Charge ``dt`` seconds of the current state's static draw to the
        idle ledger; returns the Watt·s added. The driver calls this for
        exactly the wall-clock intervals the engine did NOT step in, so the
        per-token rates (which fold idle in during steps) never
        double-count."""
        if dt <= 0.0:
            return 0.0
        ws = self.static_watts() * dt
        self.stats.idle_ws += ws
        self.stats.idle_s += dt
        return ws

    # ------------------------------------------------------------------
    def reconfigure(self, placements: Mapping[str, Placement]) -> None:
        """Swap per-kind placements. Under slot streams the swap applies to
        **newly admitted slots**: in-flight requests keep the epoch they were
        admitted under, so calling this mid-run is safe and is exactly how
        the step-windowed controller reconfigures. The wave scheduler keeps
        the stricter legacy rule (never mid-wave; a wave's tokens are costed
        under the placement that admitted it)."""
        if self._in_wave:
            raise RuntimeError("reconfigure() during a wave; use the "
                               "on_wave_end hook to apply between waves")
        was_configured = bool(self.placements)
        self.placements = dict(placements)
        if was_configured:  # the first application is configuration, not RE-
            self.stats.reconfigurations += 1

    def _token_energy(self, kind: str,
                      placements: Optional[Mapping[str, Placement]] = None
                      ) -> float:
        """Watt·s for one token of ``kind`` under a placement epoch
        (default: the engine's current placements). ``energy_correction``
        is live telemetry calibration and always applies at current value."""
        pl = self.placements if placements is None else placements
        p = pl.get(kind)
        if p is None:
            return 0.0
        return p.energy_per_token_ws * self.energy_correction.get(kind, 1.0)

    def token_energy_ws(self, kind: str) -> float:
        """Current modeled Watt·s for one token of ``kind`` (telemetry
        correction applied) — the marginal rate the fleet router compares
        across engines when routing a request by energy."""
        return self._token_energy(kind)

    # -- placement-aware admission -------------------------------------
    def modeled_latency_s(
            self, req: Request,
            placements: Optional[Mapping[str, Placement]] = None) -> float:
        """Modeled completion latency of ``req`` under a placement epoch:
        one step per prompt token at the prefill rate plus one step per
        additional generated token at the decode rate (the step consuming
        the last prompt token already emits the first output token)."""
        pl = self.placements if placements is None else placements
        pre = pl.get("prefill")
        dec = pl.get("decode")
        pre_t = pre.time_per_token_s if pre is not None else 0.0
        dec_t = dec.time_per_token_s if dec is not None else 0.0
        return (len(req.prompt) * pre_t
                + max(req.max_new_tokens - 1, 0) * dec_t)

    def _modeled_steps(self, req: Request) -> int:
        return len(req.prompt) + max(req.max_new_tokens - 1, 0)

    def slo_time_per_step_s(self) -> Optional[float]:
        """Tightest per-step time budget implied by the SLOs of queued and
        in-flight requests (None when none carries one). The controller
        folds this into the ``UserRequirement`` it narrows with, making
        latency a first-class axis next to energy."""
        budgets = [req.slo_s / max(self._modeled_steps(req), 1)
                   for req in list(self.queue) + self.active
                   if req.slo_s is not None]
        return min(budgets) if budgets else None

    def _admit(self, req: Request) -> None:
        """Common admission bookkeeping (both schedulers)."""
        if req.status == "queued":
            req.status = "active"
        req.modeled_latency_s = self.modeled_latency_s(req)
        req.served_by = self.name
        billed = self.placements.get("decode") or self.placements.get("prefill")
        req.destination = billed.destination if billed else None
        self.stats.admissions += 1
        if req.slo_s is not None and req.modeled_latency_s > req.slo_s:
            self.stats.slo_at_risk += 1
        self.active.append(req)

    def _finish(self, req: Request, reason: str) -> None:
        req.done = True
        req.finish_reason = reason
        if req.status != "truncated":  # keep the clip marker
            req.status = "done"
        self.stats.completed += 1
        if reason == "length_cap":
            self.stats.length_capped += 1
        self.active.remove(req)

    def _finish_reason(self, req: Request, tok: int, next_pos: int,
                       cap: Optional[int] = None) -> Optional[str]:
        """eos wins over max_new_tokens wins over length_cap. ``cap`` is the
        slot's effective length cap — ``max_len`` of the engine that
        ADMITTED the request, carried through mid-flight migration so a
        request moved to a roomier destination still length-caps exactly
        where its never-migrated baseline would (the differential
        serving-equivalence contract)."""
        if req.eos_id is not None and tok == req.eos_id:
            return "eos"
        if len(req.output) >= req.max_new_tokens:
            return "max_new_tokens"
        if next_pos + 1 >= (self.max_len if cap is None else cap):
            return "length_cap"  # no room for another step
        return None

    def _tokens(self, tokens: np.ndarray) -> torch.Tensor:
        """A step's host token ids as a tensor on the engine's device."""
        return torch.from_numpy(tokens).to(self.device)

    # ------------------------------------------------------------------
    # Slot-stream scheduler (session API: open / step / close)
    # ------------------------------------------------------------------
    def stream_open(self) -> None:
        """Start a slot-stream session: one shared decode state plus the
        per-slot bookkeeping, held on the engine so a simulator can step it
        incrementally across submits, power transitions and virtual time."""
        if self._stream is not None:
            raise RuntimeError("stream session already open")
        self._stream = {
            "state": T.init_decode_state(self.cfg, self.slots, self.max_len,
                                         device=self.device),
            "slot_req": [None] * self.slots,
            "cursors": [0] * self.slots,
            # placement epoch captured at admission: tokens of this slot are
            # costed under these rates no matter what reconfigure does later
            "epoch": [{} for _ in range(self.slots)],
            # effective length cap per slot: max_len of the ADMITTING engine,
            # preserved by mid-flight migration (see _finish_reason)
            "cap": [self.max_len] * self.slots,
        }

    def stream_busy(self) -> bool:
        """True while the open session has queued or in-slot work."""
        if self._stream is None:
            return False
        return bool(self.queue) \
            or any(r is not None for r in self._stream["slot_req"])

    def stream_step(self) -> Optional[list[Request]]:
        """One admission + decode step of the open session. Returns the
        requests finished by this step ([] for a step that finished none),
        or None when no step ran: nothing to serve, or the engine is not
        awake — a non-awake engine never admits a slot, never decodes and
        never bills a token. ``last_step_s`` carries the step's modeled
        duration (the max per-token time across active slots under their
        admission epochs) for virtual-clock drivers."""
        if self._stream is None:
            raise RuntimeError("no open stream session")
        if self.power_state != "awake":
            return None
        s = self._stream
        slot_req, cursors, slot_epoch = s["slot_req"], s["cursors"], s["epoch"]
        caps = s["cap"]
        # admission: every free slot takes the next queued request — a
        # slot freed on step t serves its new request on step t+1
        newly = []
        for i in range(self.slots):
            if slot_req[i] is None and self.queue:
                req = self.queue.popleft()
                slot_req[i] = req
                cursors[i] = 0
                slot_epoch[i] = dict(self.placements)
                caps[i] = self.max_len
                self._admit(req)
                newly.append(i)
        if not any(r is not None for r in slot_req):
            return None
        if newly:
            mask = np.zeros((self.slots,), bool)
            mask[newly] = True
            s["state"] = T.reset_decode_slots(
                self.cfg, s["state"], torch.from_numpy(mask).to(self.device))
        step_s = 0.0
        tokens = np.zeros((self.slots,), np.int32)
        for i, req in enumerate(slot_req):
            if req is None:
                continue
            c = cursors[i]
            tokens[i] = (req.prompt[c] if c < len(req.prompt)
                         else req.output[-1])
            kind = "prefill" if c < len(req.prompt) else "decode"
            p = slot_epoch[i].get(kind)
            if p is not None:
                step_s = max(step_s, p.time_per_token_s)
        self.last_step_s = step_s
        logits, s["state"] = self._step(self.model, s["state"],
                                        self._tokens(tokens))
        self.stats.steps += 1
        self.stats.slot_steps += self.slots
        self.stats.active_slot_steps += sum(r is not None for r in slot_req)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()  # sync
        done: list[Request] = []
        for i, req in enumerate(slot_req):
            if req is None:
                continue
            c = cursors[i]
            cursors[i] += 1
            # the step consuming a prompt token is PREFILL — including
            # the one consuming the last prompt token (which already
            # emits the first output token): a length-L prompt
            # contributes exactly L prefill tokens
            if c < len(req.prompt):
                self.stats.prefill_tokens += 1
                self.stats.energy_ws += self._token_energy(
                    "prefill", slot_epoch[i])
            else:
                self.stats.decode_tokens += 1
                self.stats.energy_ws += self._token_energy(
                    "decode", slot_epoch[i])
            if c >= len(req.prompt) - 1:  # this step emitted a token
                tok = int(nxt[i])
                req.output.append(tok)
                reason = self._finish_reason(req, tok, cursors[i], caps[i])
                if reason is not None:
                    self._finish(req, reason)
                    done.append(req)
                    slot_req[i] = None  # freed; refilled next step
        if self.on_step_end is not None:
            self.on_step_end(self)
        return done

    def stream_close(self) -> None:
        """End the session. In-slot requests are marked ``incomplete`` (the
        submit guard bounds every request to < max_len steps, so a closing
        session only strands work when its step budget was under-provisioned
        — mark survivors rather than launder them as done); queued requests
        stay queued."""
        if self._stream is None:
            return
        for req in self._stream["slot_req"]:
            if req is not None:
                req.status = "incomplete"
                self.stats.incomplete += 1
                self.active.remove(req)
        self._stream = None

    def _run_stream(self, max_steps: int) -> list[Request]:
        self.stream_open()
        done: list[Request] = []
        try:
            for _ in range(max_steps):
                finished = self.stream_step()
                if finished is None:  # nothing active (or not awake)
                    break
                done.extend(finished)
        finally:
            self.stream_close()
        return done

    # ------------------------------------------------------------------
    # Wave scheduler (legacy, scheduler="wave"; session API mirrors the
    # stream scheduler's so mid-flight migration works under both)
    # ------------------------------------------------------------------
    def wave_open(self, wave: list[Request]) -> None:
        """Start a wave session over up to ``slots`` requests: one fresh
        decode state plus per-slot bookkeeping held on the engine, so a
        test or migration driver can step the wave incrementally (the
        legacy closed loop, ``_run_wave``, is now a thin driver over this).
        Epoch and cap are tracked per slot — identical for every admitted
        member (the wave rule), but a slot restored by mid-flight migration
        carries its own."""
        if self._wave is not None:
            raise RuntimeError("wave session already open")
        self.stats.waves += 1
        self._in_wave = True
        self._wave = {
            "state": T.init_decode_state(self.cfg, self.slots, self.max_len,
                                         device=self.device),
            "reqs": list(wave),
            "cursors": [0] * len(wave),
            "active": [True] * len(wave),
            "epoch": [dict(self.placements) for _ in wave],
            "cap": [self.max_len] * len(wave),
            "steps": 0,
        }
        for req in wave:
            self._admit(req)

    def wave_step(self) -> Optional[list[Request]]:
        """One decode step of the open wave session. Returns the requests
        finished by this step, or None when the wave is drained (or its
        ``max_len`` step bound — unreachable under the submit guard — is
        exhausted)."""
        if self._wave is None:
            raise RuntimeError("no open wave session")
        w = self._wave
        reqs, cursors, active = w["reqs"], w["cursors"], w["active"]
        if not any(active) or w["steps"] >= self.max_len:
            return None
        tokens = np.zeros((self.slots,), np.int32)
        for i, req in enumerate(reqs):
            if not active[i]:
                continue
            c = cursors[i]
            tokens[i] = (req.prompt[c] if c < len(req.prompt)
                         else req.output[-1])
        logits, w["state"] = self._step(self.model, w["state"],
                                        self._tokens(tokens))
        w["steps"] += 1
        self.stats.steps += 1
        self.stats.slot_steps += self.slots
        self.stats.active_slot_steps += sum(active)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()  # sync
        done: list[Request] = []
        for i, req in enumerate(reqs):
            if not active[i]:
                continue
            c = cursors[i]
            cursors[i] += 1
            # prefill/decode attribution: the step consuming the
            # last prompt token is prefill (see _run_stream)
            kind = "prefill" if c < len(req.prompt) else "decode"
            self.stats.prefill_tokens += kind == "prefill"
            self.stats.decode_tokens += kind == "decode"
            self.stats.energy_ws += self._token_energy(kind, w["epoch"][i])
            if c >= len(req.prompt) - 1:
                tok = int(nxt[i])
                req.output.append(tok)
                reason = self._finish_reason(req, tok, cursors[i],
                                             w["cap"][i])
                if reason is not None:
                    self._finish(req, reason)
                    done.append(req)
                    active[i] = False
        return done

    def wave_close(self) -> None:
        """End the wave session. Still-active slots are marked
        ``incomplete`` (the submit guard makes wave exhaustion unreachable,
        but if it ever happens the request is marked, not laundered as
        done)."""
        if self._wave is None:
            return
        for i, req in enumerate(self._wave["reqs"]):
            if self._wave["active"][i]:
                req.status = "incomplete"
                self.stats.incomplete += 1
                self.active.remove(req)
        self._wave = None
        self._in_wave = False

    def _run_wave(self, wave: list[Request]) -> None:
        self.wave_open(wave)
        try:
            while self.wave_step() is not None:
                pass
        finally:
            self.wave_close()

    def run(self, max_waves: int = 64,
            max_steps: Optional[int] = None) -> list[Request]:
        """Serve the queue; returns the *finished* requests in completion
        order. Under slot streams the budget is ``max_steps`` (default
        ``max_waves * max_len``, the same work ceiling the wave scheduler
        had); ``max_waves`` bounds the wave scheduler."""
        if self.scheduler == "stream":
            if max_steps is None:
                max_steps = max_waves * self.max_len
            return self._run_stream(max_steps)
        done: list[Request] = []
        for _ in range(max_waves):
            if not self.queue:
                break
            wave = [self.queue.popleft()
                    for _ in range(min(self.slots, len(self.queue)))]
            self._run_wave(wave)
            done.extend(r for r in wave if r.done)
            if self.on_wave_end is not None:
                self.on_wave_end(self)
        return done
