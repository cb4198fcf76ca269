"""Serving driver: batched requests through the slot-stream engine (the
default scheduler; ``--scheduler wave`` selects the legacy wave scheduler),
on one card.

Counterpart of the JAX package's ``launch/serve.py`` for one engine.
``--full`` serves the published config (``python -m repro_torch.launch.serve
--full`` serves llama3.2-3b at full width and depth on the card, ``--arch
rwkv6-1.6b --full`` rwkv6-1.6b, ``--arch zamba2-7b --full`` zamba2-7b,
``--arch seamless-m4t-medium --full`` the enc-dec seamless-m4t-medium and
``--arch llava-next-mistral-7b --full`` the VLM llava-next-mistral-7b;
requests are tokens only, as in the reference, so the enc-dec decoder
attends to a zero memory and the VLM takes no patches); without it the
reduced config is served, as ``--arch mixtral-8x7b`` and
``--arch grok-1-314b`` serve the MoE family's on the card. Their published
configs do not fit one card: ``--full`` would need 93.4 GB of bf16 weights
for mixtral-8x7b and 633 GB for grok-1-314b, where an H100 holds 80 GB.
The weights are random, drawn from a generator seeded 0 on the device.

As in the reference, the engine serves under the static paper-faithful
placement of the published config (``static_placements(arch,
DEFAULT_MESH)``), so ``energy_ws``, ``ws_per_1k_tokens``, ``placements``
and ``served_by`` carry the modeled Watt·s the offload search minimises:
``TpuPowerModel``'s, a TPU v5e model, equal to the reference's and not the
card's draw, which ``repro_torch.telemetry`` meters around the call.
``--adaptive`` attaches the traffic-adaptive :class:`~repro_torch.runtime.
PlacementController`, which re-plans from the observed traffic mix every
``interval_steps`` steps (between waves under ``--scheduler wave``)
through the disk-persisted measurement cache at ``cache_path``.

``--fleet`` serves through the :class:`~repro_torch.runtime.router.
FleetRouter` instead: one engine per mixed-environment catalog destination
(``configs/destinations.py``), all sharing the one model on the card,
requests routed by ``--policy`` (energy | latency | round_robin), with one
shared sweep re-planning every engine mid-run when ``--adaptive`` is also
set. Every served request reports which engine/destination billed it.
``--provision-budget-w W`` (with ``--fleet``) runs the capacity planner
first: the fleet is the destination multiset ``repro_torch.provision``
recommends under a W-watt nameplate budget for a small default forecast.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import models as M
from repro_torch._device import resolve_device
from repro_torch.configs import get_config, mixed_fleet, \
    reduced as reduce_cfg
from repro_torch.core.ga import GAConfig
from repro_torch.runtime import FleetRouter, PlacementController, Request, \
    ServingEngine, static_placements
from repro_torch.runtime.placement import DEFAULT_MESH_OPTIONS
from repro_torch.workload import TenantSpec

DEFAULT_MESH = DEFAULT_MESH_OPTIONS[0]
# the two tenants of the capacity planner's default forecast: chat with an
# SLO, and batch
TENANTS = (
    TenantSpec("chat", weight=3.0, prompt_median=6, prompt_max=14,
               new_tokens_median=4, new_tokens_max=8, slo_s=0.05),
    TenantSpec("batch", weight=1.0, prompt_median=10, prompt_max=20,
               new_tokens_median=6, new_tokens_max=10),
)


def _requests(num_requests: int, max_new_tokens: int) -> list[Request]:
    return [Request(rid=i, prompt=[1 + i % 7, 2, 3 + i % 5],
                    max_new_tokens=max_new_tokens)
            for i in range(num_requests)]


def _model(cfg, device: torch.device):
    """Random weights for ``cfg`` drawn on ``device`` from a generator
    seeded 0."""
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    return M.init_params(cfg, generator)


def serve(arch: str = "llama3.2-3b", *, use_reduced: bool = True,
          num_requests: int = 8, slots: int = 4, max_new_tokens: int = 8,
          max_len: int = 64, adaptive: bool = False,
          cache_path: Optional[str] = "results/eval_cache.jsonl",
          interval_waves: int = 1, interval_steps: int = 16,
          scheduler: str = "stream", device=None) -> dict:
    """Serve ``num_requests`` short requests on ``device`` (None: the
    card) and return the reference's report, plus ``total_tokens`` and
    ``device``."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduce_cfg(cfg)
    model = _model(cfg, device)
    engine = ServingEngine(cfg, model, slots=slots, max_len=max_len,
                           scheduler=scheduler, device=device)
    # modeled production-cell energy rates (full config, not the reduced one
    # actually decoding locally): the Watt·s ledger the search minimizes
    engine.reconfigure(static_placements(arch, DEFAULT_MESH))
    controller = None
    if adaptive:
        controller = PlacementController(
            engine, arch, DEFAULT_MESH_OPTIONS, cache_path=cache_path,
            ga_config=GAConfig(population=10, generations=8),
            interval_waves=interval_waves,
            interval_steps=interval_steps).attach()
    for r in _requests(num_requests, max_new_tokens):
        engine.submit(r)
    t0 = time.time()
    done = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    toks = engine.stats.decode_tokens
    total = engine.stats.total_tokens
    return {
        "completed": len(done),
        "rejected": engine.stats.rejected,
        "decode_tokens": toks,
        "total_tokens": total,
        "wall_s": wall,
        "tokens_per_s": toks / max(wall, 1e-9),
        "waves": engine.stats.waves,
        "steps": engine.stats.steps,
        "occupancy": engine.stats.occupancy,
        "energy_ws": engine.stats.energy_ws,
        "ws_per_1k_tokens": engine.stats.energy_ws / max(total, 1) * 1e3,
        "reconfigurations": engine.stats.reconfigurations,
        "placements": {k: (p.destination, p.clock, p.source)
                       for k, p in engine.placements.items()},
        "new_measurements": (sum(r.new_measurements
                                 for r in controller.history)
                             if controller else 0),
        "device": str(device),
        "outputs": {r.rid: r.output for r in done},
        "served_by": {r.rid: (r.served_by, r.destination) for r in done},
    }


def _provision_counts(arch: str, budget_w: float,
                      cache_path: Optional[str]) -> dict[str, int]:
    """Run the capacity planner: the destination multiset to build under a
    ``budget_w``-watt nameplate budget for a small default diurnal
    forecast."""
    from repro_torch.configs import DESTINATIONS
    from repro_torch.provision import Budget, destination_economics, \
        plan_fleet
    from repro_torch.runtime.placement import DEFAULT_CATALOG
    from repro_torch.workload import WorkloadSpec
    from repro_torch.workload.forecast import WorkloadForecast

    spec = WorkloadSpec(
        seed=7, duration_s=0.06, rate_rps=15000.0, max_len=32,
        arrival="poisson", diurnal_period_s=0.06, diurnal_trough=0.15,
        diurnal_peak=2.0, tenants=TENANTS)
    econ = destination_economics(
        arch, list(DESTINATIONS.values()), shapes=DEFAULT_CATALOG,
        slots=2, cache_path=cache_path,
        ga_config=GAConfig(population=10, generations=8, seed=0))
    result = plan_fleet(econ.economics, Budget.create(budget_w),
                        WorkloadForecast.from_spec(spec))
    if result.best is None:
        raise SystemExit(f"--provision-budget-w {budget_w}: no destination "
                         "type is buildable under that budget")
    return result.counts


def serve_fleet(arch: str = "llama3.2-3b", *, use_reduced: bool = True,
                num_requests: int = 8, slots: int = 2,
                max_new_tokens: int = 8, max_len: int = 64,
                policy: str = "energy", adaptive: bool = False,
                cache_path: Optional[str] = "results/eval_cache.jsonl",
                scheduler: str = "stream",
                provision_budget_w: Optional[float] = None,
                device=None) -> dict:
    """Serve across the mixed-destination fleet (one engine per catalog
    destination, all on ``device``; None: the card). With ``adaptive``,
    one shared sweep re-plans every engine between two serving phases.
    With ``provision_budget_w``, the fleet is not the whole catalog but the
    multiset the capacity planner recommends under that nameplate watt
    budget. Returns the reference's report, plus ``total_tokens`` and
    ``device``."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduce_cfg(cfg)
    model = _model(cfg, device)
    kwargs = dict(arch=arch, policy=policy, slots=slots, max_len=max_len,
                  scheduler=scheduler, cache_path=cache_path,
                  ga_config=GAConfig(population=10, generations=8),
                  device=device)
    if provision_budget_w is not None:
        counts = _provision_counts(arch, provision_budget_w, cache_path)
        router = FleetRouter.provisioned(cfg, model, counts, **kwargs)
    else:
        router = FleetRouter(cfg, model, mixed_fleet(), **kwargs)
    reqs = _requests(num_requests, max_new_tokens)
    half = len(reqs) // 2 if adaptive else len(reqs)
    t0 = time.time()
    for r in reqs[:half]:
        router.submit(r)
    done = router.run()
    if adaptive:
        router.plan()
        for r in reqs[half:]:
            router.submit(r)
        done += router.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    s = router.fleet_stats()
    return {
        "completed": len(done),
        "rejected": s.rejected,
        "decode_tokens": s.decode_tokens,
        "total_tokens": s.total_tokens,
        "wall_s": wall,
        "tokens_per_s": s.decode_tokens / max(wall, 1e-9),
        "steps": s.steps,
        "occupancy": s.occupancy,
        "energy_ws": s.energy_ws,
        "ws_per_1k_tokens": s.energy_ws / max(s.total_tokens, 1) * 1e3,
        "reconfigurations": s.reconfigurations,
        "slo_at_risk": s.slo_at_risk,
        "engines": {b.name: b.dest.description for b in router.bindings},
        "new_measurements": sum(r.new_measurements for r in router.history),
        "device": str(device),
        "outputs": {r.rid: r.output for r in done},
        "served_by": {r.rid: (r.served_by, r.destination) for r in done},
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="serve the published config, not the reduced one")
    ap.add_argument("--scheduler", default="stream",
                    choices=("stream", "wave"),
                    help="stream = slot-stream continuous batching (the "
                         "default scheduler); wave = the legacy wave "
                         "scheduler, kept for reproducible comparisons")
    ap.add_argument("--adaptive", action="store_true",
                    help="traffic-adaptive placement (observe/sweep/narrow/"
                         "reconfigure on a step-count window, or between "
                         "waves under --scheduler wave)")
    ap.add_argument("--fleet", action="store_true",
                    help="serve across the mixed-destination fleet "
                         "(FleetRouter, one engine per catalog destination)")
    ap.add_argument("--policy", default="energy",
                    choices=("energy", "latency", "round_robin"),
                    help="fleet routing policy (with --fleet)")
    ap.add_argument("--provision-budget-w", type=float, default=None,
                    help="with --fleet: run the capacity planner and serve "
                         "on the destination multiset it recommends under "
                         "this nameplate watt budget, instead of the whole "
                         "catalog")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    if args.provision_budget_w is not None and not args.fleet:
        ap.error("--provision-budget-w requires --fleet")
    if args.fleet:
        out = serve_fleet(args.arch, use_reduced=not args.full,
                          num_requests=args.requests, slots=args.slots,
                          max_new_tokens=args.max_new_tokens,
                          policy=args.policy, adaptive=args.adaptive,
                          scheduler=args.scheduler,
                          provision_budget_w=args.provision_budget_w,
                          device=args.device)
    else:
        out = serve(args.arch, use_reduced=not args.full,
                    num_requests=args.requests, slots=args.slots,
                    max_new_tokens=args.max_new_tokens,
                    adaptive=args.adaptive, scheduler=args.scheduler,
                    device=args.device)
    print(f"served {out['completed']} requests, {out['decode_tokens']} tokens "
          f"in {out['wall_s']:.2f}s ({out['tokens_per_s']:.1f} tok/s, "
          f"{out['steps']} steps, occupancy {out['occupancy']:.2f}) on "
          f"{out['device']}")
    print(f"modeled energy: {out['energy_ws']:.0f} Ws "
          f"({out['ws_per_1k_tokens']:.0f} Ws/1k tokens), "
          f"{out['reconfigurations']} reconfigurations")
    for rid, (engine, destination) in sorted(out["served_by"].items()):
        print(f"  rid={rid} engine={engine} destination={destination}")


if __name__ == "__main__":
    main()
