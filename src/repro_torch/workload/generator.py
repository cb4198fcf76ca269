"""Open-loop, seed-deterministic traffic generation at fleet scale.

The bench scenarios before this module were a handful of hand-built request
lists: the router never saw queueing pressure, and no engine was ever worth
spinning down. This generator produces the load a million-user deployment
actually presents — timestamped request *streams* the fleet consumes at
wall-clock-simulated rates (``workload/driver.py``) — while staying exactly
reproducible: the same :class:`WorkloadSpec` (same seed) emits a
byte-identical trace, pinned by :func:`trace_digest`.

Modeled phenomena (cf. the 33-app power evaluation of arXiv:2110.11520 —
energy conclusions need realistic, reproducible load):

* **arrival processes** — open-loop Poisson (exponential interarrivals) or
  **bursty** (a two-state Markov-modulated Poisson process: quiet base rate
  with seeded burst episodes at a rate multiplier), both modulated by a
  **diurnal cycle**: a sinusoidal rate envelope between ``trough`` and
  ``peak`` multipliers with a configurable period — the load shape that
  makes energy-proportional autoscaling matter (idle watts during the
  trough are pure waste for an always-on fleet).
* **heavy-tailed lengths** — prompt and output lengths are discretized
  log-normals (most requests short, a long tail), clamped to configured
  caps so the stream **never** emits a ``prompt >= max_len`` reject: every
  request fits its engine by construction, with room for at least one
  generated token.
* **SLO classes + multi-tenant mixes** — each :class:`TenantSpec` is one
  tenant class (interactive chat, batch summarization, ...) with its own
  length profile, optional completion SLO and traffic weight; the stream
  interleaves tenants by weighted seeded choice.

Everything uses ``random.Random(seed)`` (pure Python, platform-stable) —
no wall clocks, no numpy RNG state: two calls with one spec are
byte-identical, and identical to the JAX package's trace for the same
spec.
"""
from __future__ import annotations

import hashlib
import math
import random
from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence

from repro_torch.runtime.serving import Request

ARRIVALS = ("poisson", "bursty")


@dataclass(frozen=True)
class TenantSpec:
    """One tenant class: a length profile, an SLO class and a mix weight.

    Lengths are log-normal in shape: ``exp(N(log(median), sigma))``,
    discretized and clamped to ``[lo, hi]`` — median-parameterized so specs
    read naturally ("median 12-token prompts, heavy tail to 64")."""

    name: str
    weight: float = 1.0
    prompt_median: int = 12
    prompt_sigma: float = 0.6
    prompt_max: int = 48
    new_tokens_median: int = 6
    new_tokens_sigma: float = 0.5
    new_tokens_max: int = 16
    slo_s: Optional[float] = None  # completion-latency SLO (None = batch)
    eos_id: Optional[int] = None
    vocab: int = 17  # prompt tokens are drawn from [1, vocab]


@dataclass(frozen=True)
class WorkloadSpec:
    """One reproducible open-loop workload.

    ``rate_rps`` is the *mean* arrival rate in requests per (simulated)
    second before diurnal/burst modulation; ``duration_s`` bounds the
    arrival timeline. ``max_len`` is the serving engines' cache length: the
    generator guarantees ``len(prompt) + 1 <= max_len`` for every emitted
    request (no admission rejects, ever) by clamping prompts to
    ``min(tenant.prompt_max, max_len - 1)`` and additionally leaving room
    for the request's own generation budget when ``reserve_output`` is set
    (no ``length_cap`` finishes either)."""

    seed: int = 0
    duration_s: float = 1.0
    rate_rps: float = 100.0
    max_len: int = 48
    arrival: str = "poisson"  # "poisson" | "bursty"
    # diurnal sinusoid: rate(t) = rate_rps * lerp(trough, peak) over period
    diurnal_period_s: float = 0.0  # 0 = flat (no cycle)
    diurnal_trough: float = 1.0  # rate multiplier at the valley
    diurnal_peak: float = 1.0  # rate multiplier at the crest
    # bursty (MMPP) knobs: mean episode lengths + in-burst multiplier
    burst_rate_mult: float = 4.0
    burst_mean_s: float = 0.05
    quiet_mean_s: float = 0.2
    reserve_output: bool = True  # prompts leave room for max_new_tokens too
    tenants: tuple[TenantSpec, ...] = (TenantSpec("default"),)

    def __post_init__(self) -> None:
        if self.arrival not in ARRIVALS:
            raise ValueError(f"unknown arrival process {self.arrival!r}; "
                             f"one of {ARRIVALS}")
        if self.rate_rps <= 0.0 or self.duration_s <= 0.0:
            raise ValueError("rate_rps and duration_s must be positive")
        if self.max_len < 2:
            raise ValueError("max_len must fit a prompt token plus a "
                             "generated one")
        if not self.tenants:
            raise ValueError("need at least one tenant")
        if self.diurnal_period_s > 0.0 and not (
                0.0 <= self.diurnal_trough <= self.diurnal_peak):
            raise ValueError("diurnal multipliers need "
                             "0 <= trough <= peak")


@dataclass(frozen=True)
class TimedRequest:
    """One arrival: when it hits the front door, whose it is, what it asks."""

    at_s: float
    tenant: str
    request: Request = field(compare=False)

    @property
    def rid(self) -> int:
        return self.request.rid

    def tokens(self) -> int:
        """Total token demand this arrival puts on the fleet (prompt +
        generation budget) — what autoscaling sizes capacity against."""
        return len(self.request.prompt) + self.request.max_new_tokens


def diurnal_mult(spec: WorkloadSpec, t: float) -> float:
    """Rate multiplier at time ``t``: a sinusoid from ``diurnal_peak`` (at
    t=0) down to ``diurnal_trough`` and back over ``diurnal_period_s``."""
    if spec.diurnal_period_s <= 0.0:
        return 1.0
    phase = math.cos(2.0 * math.pi * t / spec.diurnal_period_s)
    lo, hi = spec.diurnal_trough, spec.diurnal_peak
    return lo + (hi - lo) * 0.5 * (1.0 + phase)


def _lognormal_int(rng: random.Random, median: int, sigma: float,
                   lo: int, hi: int) -> int:
    """Discretized log-normal with the given median, clamped to [lo, hi]."""
    if hi <= lo:
        return max(lo, 1)
    v = int(round(math.exp(rng.gauss(math.log(max(median, 1)), sigma))))
    return max(lo, min(hi, v))


def _arrival_times(spec: WorkloadSpec, rng: random.Random) -> Iterator[float]:
    """Arrival timestamps on [0, duration): a Poisson process thinned by the
    diurnal envelope, with the bursty variant layering a two-state MMPP
    (quiet/burst) rate multiplier on top.

    Thinning draws candidates at the *maximum* instantaneous rate and keeps
    each with probability rate(t)/rate_max — the standard exact method for
    inhomogeneous Poisson processes, and deterministic under the seeded
    rng."""
    peak_mult = (max(spec.diurnal_peak, 1e-9)
                 if spec.diurnal_period_s > 0.0 else 1.0)
    burst_mult = spec.burst_rate_mult if spec.arrival == "bursty" else 1.0
    rate_max = spec.rate_rps * max(peak_mult, 1e-9) * max(burst_mult, 1.0)

    in_burst = False
    phase_end = 0.0
    t = 0.0
    while True:
        t += rng.expovariate(rate_max)
        if t >= spec.duration_s:
            return
        rate = spec.rate_rps * diurnal_mult(spec, t)
        if spec.arrival == "bursty":
            while t >= phase_end:  # advance the MMPP phase machine to t
                in_burst = not in_burst if phase_end > 0.0 else \
                    rng.random() < spec.burst_mean_s / max(
                        spec.burst_mean_s + spec.quiet_mean_s, 1e-9)
                mean = spec.burst_mean_s if in_burst else spec.quiet_mean_s
                phase_end += rng.expovariate(1.0 / max(mean, 1e-9))
            if in_burst:
                rate *= spec.burst_rate_mult
        if rng.random() < rate / rate_max:
            yield t


def _pick_tenant(spec: WorkloadSpec, rng: random.Random) -> TenantSpec:
    total = sum(t.weight for t in spec.tenants)
    x = rng.random() * total
    for t in spec.tenants:
        x -= t.weight
        if x <= 0.0:
            return t
    return spec.tenants[-1]


def generate(spec: WorkloadSpec, *, rid_base: int = 0) -> list[TimedRequest]:
    """Emit the full arrival trace for ``spec`` — deterministically.

    Each arrival draws its tenant by weight, then its prompt/output lengths
    from the tenant's clamped log-normals. Prompt caps guarantee admission:
    ``len(prompt) < max_len`` always, and with ``reserve_output`` the prompt
    additionally leaves the request's whole generation budget inside
    ``max_len`` (no silent ``length_cap`` finishes)."""
    rng = random.Random(spec.seed)
    out: list[TimedRequest] = []
    for i, t in enumerate(_arrival_times(spec, rng)):
        tenant = _pick_tenant(spec, rng)
        new_max = min(tenant.new_tokens_max, spec.max_len - 1)
        gen = _lognormal_int(rng, tenant.new_tokens_median,
                             tenant.new_tokens_sigma, 1, new_max)
        cap = spec.max_len - 1
        if spec.reserve_output:
            cap = spec.max_len - gen
        cap = min(tenant.prompt_max, cap)
        plen = _lognormal_int(rng, tenant.prompt_median, tenant.prompt_sigma,
                              1, cap)
        prompt = [1 + rng.randrange(tenant.vocab) for _ in range(plen)]
        req = Request(rid=rid_base + i, prompt=prompt, max_new_tokens=gen,
                      eos_id=tenant.eos_id, slo_s=tenant.slo_s)
        out.append(TimedRequest(at_s=t, tenant=tenant.name, request=req))
    return out


def trace_bytes(trace: Sequence[TimedRequest]) -> bytes:
    """Canonical byte serialization of a trace (what determinism means)."""
    lines = []
    for tr in trace:
        r = tr.request
        lines.append("|".join((
            f"{tr.at_s!r}", tr.tenant, str(r.rid),
            ",".join(map(str, r.prompt)), str(r.max_new_tokens),
            repr(r.slo_s), repr(r.eos_id))))
    return "\n".join(lines).encode("utf-8")


def trace_digest(trace: Sequence[TimedRequest]) -> str:
    """SHA-256 of the canonical serialization: equal digests == the same
    trace, byte for byte — the reproducibility handle."""
    return hashlib.sha256(trace_bytes(trace)).hexdigest()


def empirical_rate_rps(trace: Sequence[TimedRequest],
                       duration_s: float) -> float:
    return len(trace) / duration_s if duration_s > 0 else 0.0


def mean_diurnal_mult(spec: WorkloadSpec, n: int = 512) -> float:
    """Time-average of the diurnal envelope (for rate-tolerance tests: the
    empirical arrival rate estimates ``rate_rps`` x this average)."""
    if spec.diurnal_period_s <= 0.0:
        return 1.0
    return sum(diurnal_mult(spec, spec.duration_s * (i + 0.5) / n)
               for i in range(n)) / n
