"""Workload forecasts: the demand summary capacity planning provisions for.

Provisioning (``repro_torch.provision``) decides *which destinations to build*
before any request arrives, so it cannot observe traffic the way the
router's control loop does — it plans against a **forecast**: a compact,
deterministic summary of the traffic a :class:`WorkloadSpec` describes.
:func:`WorkloadForecast.from_spec` generates the spec's seed-deterministic
trace once (``workload/generator.py`` — byte-identical per seed, pinned by
``trace_digest``) and reduces it to exactly the quantities a capacity plan
needs:

* **mean and peak token rates** — the mean sizes the energy bill (what the
  fleet serves second over second); the peak sizes capacity (what the
  built fleet must be able to absorb). Peak is the maximum windowed token
  arrival rate over ``peak_windows`` equal slices of the horizon, so a
  diurnal crest or burst episode shows up instead of averaging away.
* **prefill/decode split** — destinations differ in which kind they serve
  cheaply (``configs/destinations.py``: compute-optimized parts win
  prefill, memory-optimized parts win decode), so the mix weighting is
  what makes heterogeneous builds score differently at all.
* **per-tenant latency profiles** — observed median prompt/output lengths
  plus the spec's completion SLOs: enough to ask "can destination D finish
  this tenant's median request inside its SLO?" without replaying traffic.

Everything derives from the generated trace (not the spec's nominal
parameters), so clamping, diurnal thinning and tenant weighting are already
folded in, and the same spec always produces the identical forecast — the
determinism the provisioning plans rest on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.workload.generator import (
    TimedRequest, WorkloadSpec, generate, trace_digest,
)


def _median_int(values: Sequence[int]) -> int:
    """Lower median (deterministic, integer-valued) of a non-empty list."""
    ordered = sorted(values)
    return ordered[(len(ordered) - 1) // 2]


@dataclass(frozen=True)
class TenantForecast:
    """One tenant class's planning profile, measured from the trace."""

    name: str
    requests: int
    prompt_median: int  # observed median prompt length (tokens)
    new_tokens_median: int  # observed median generation budget
    slo_s: Optional[float]  # completion SLO (None = batch traffic)


@dataclass(frozen=True)
class WorkloadForecast:
    """The demand summary a provisioning search evaluates fleets against."""

    duration_s: float
    requests: int
    total_tokens: int  # prompt + generation budget over the whole trace
    mean_tps: float  # total_tokens / duration
    peak_tps: float  # max windowed arrival rate (capacity sizing)
    prefill_frac: float  # prompt share of total tokens
    tenants: tuple[TenantForecast, ...]
    trace_digest: str  # the generated trace this forecast summarizes

    @property
    def decode_frac(self) -> float:
        return 1.0 - self.prefill_frac

    def slo_tenants(self) -> tuple[TenantForecast, ...]:
        return tuple(t for t in self.tenants if t.slo_s is not None)

    @staticmethod
    def from_trace(trace: Sequence[TimedRequest], duration_s: float,
                   *, peak_windows: int = 16) -> "WorkloadForecast":
        """Summarize an already-generated trace (``from_spec`` is the
        usual entry; this one serves tests and replayed live traces)."""
        if duration_s <= 0.0:
            raise ValueError("duration_s must be positive")
        windows = max(int(peak_windows), 1)
        win = duration_s / windows
        bucket_tokens = [0] * windows
        prompt_tokens = 0
        total_tokens = 0
        per_tenant: dict[str, list[TimedRequest]] = {}
        for tr in trace:
            tokens = tr.tokens()
            total_tokens += tokens
            prompt_tokens += len(tr.request.prompt)
            idx = min(int(tr.at_s / win), windows - 1)
            bucket_tokens[idx] += tokens
            per_tenant.setdefault(tr.tenant, []).append(tr)
        tenants = tuple(
            TenantForecast(
                name=name,
                requests=len(trs),
                prompt_median=_median_int(
                    [len(t.request.prompt) for t in trs]),
                new_tokens_median=_median_int(
                    [t.request.max_new_tokens for t in trs]),
                slo_s=trs[0].request.slo_s)
            for name, trs in sorted(per_tenant.items()))
        return WorkloadForecast(
            duration_s=duration_s,
            requests=len(trace),
            total_tokens=total_tokens,
            mean_tps=total_tokens / duration_s,
            peak_tps=max(bucket_tokens) / win if trace else 0.0,
            prefill_frac=(prompt_tokens / total_tokens
                          if total_tokens else 0.0),
            tenants=tenants,
            trace_digest=trace_digest(trace))

    @staticmethod
    def from_spec(spec: WorkloadSpec, *,
                  peak_windows: int = 16) -> "WorkloadForecast":
        """Generate ``spec``'s deterministic trace and summarize it."""
        return WorkloadForecast.from_trace(
            generate(spec), spec.duration_s, peak_windows=peak_windows)

    def to_json(self) -> dict:
        return {
            "duration_s": self.duration_s,
            "requests": self.requests,
            "total_tokens": self.total_tokens,
            "mean_tps": self.mean_tps,
            "peak_tps": self.peak_tps,
            "prefill_frac": self.prefill_frac,
            "trace_digest": self.trace_digest,
            "tenants": [
                {"name": t.name, "requests": t.requests,
                 "prompt_median": t.prompt_median,
                 "new_tokens_median": t.new_tokens_median,
                 "slo_s": t.slo_s}
                for t in self.tenants],
        }
