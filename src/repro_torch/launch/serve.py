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
``--fleet`` and ``--provision-budget-w`` wait for slice 4b of the port.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import models as M
from repro_torch._device import resolve_device
from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.core.ga import GAConfig
from repro_torch.runtime import PlacementController, Request, \
    ServingEngine, static_placements
from repro_torch.runtime.placement import DEFAULT_MESH_OPTIONS

DEFAULT_MESH = DEFAULT_MESH_OPTIONS[0]


def _requests(num_requests: int, max_new_tokens: int) -> list[Request]:
    return [Request(rid=i, prompt=[1 + i % 7, 2, 3 + i % 5],
                    max_new_tokens=max_new_tokens)
            for i in range(num_requests)]


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
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    model = M.init_params(cfg, generator)
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
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
