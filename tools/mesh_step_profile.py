"""What the mesh layer costs a train step on one card.

    PYTHONPATH=src python3 tools/mesh_step_profile.py [--steps N] [--json PATH]
    python3 tools/mesh_step_profile.py --ab BASE CHANGE [--steps N]
        [--json PATH]

llama3.2-3b at full width and depth in bf16 (remat full, AdamW at lr 3e-4)
on one H100. One train state serves three steps, which take it in turns:
``single``, ``launch/train.py`` ``train_step`` on 2 rows of 2048 tokens
(the single-device path); ``mesh1``, ``launch/steps.py``
``build_train_step`` on a 1x1 ("data", "model") mesh at accum 1 on the
same 2 rows (the same work through the mesh layer); ``mesh4``, the same
at the config's own accum of 4 on 8 rows (``train(mesh=...)``'s step). The
mesh steps see the state as DTensors that share its storage. Order:
single, mesh1, mesh4, mesh4, mesh1, single; each run one untimed step,
then N timed (host clock around a synchronised step), its median kept.
The mesh layer's own helpers (``parallel/sharding.py``: layouts, gathers,
chunks, reductions) are wrapped to add up their host time a step. Then one
``mesh4`` step under ``torch.profiler``: device time, busy share, the
NCCL kernels' time (none is expected on a 1x1 mesh) and the top device
and host ops. Each run also reads its peak device memory and, where the
package has the layer gather (``parallel/sharding.py`` ``LayerShards``),
its calls, bytes copied and host time a step. Prints one JSON line, with
the card's name and power limit. Needs a CUDA card.

With ``--ab``, BASE and CHANGE are the roots of two checkouts (for example
the parent commit unpacked with ``git archive``): this script runs in a
fresh process against each one's ``src`` in the order base, change,
change, base, and prints each run's result and each side's median over
its two runs of every run kind's step ms and peak memory.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

HELPERS = ("full", "local", "like", "local_chunk", "to_placements",
           "from_placements", "reduce_over", "mean_over", "batch_sum",
           "assign", "distribute")


def _timed_helpers(spent: collections.Counter) -> list:
    """Wrap the mesh layer's helpers, where the step builders and the
    optimizers call them, to add their host seconds to ``spent``; returns
    the (module, name, original) triples to put back."""
    from repro_torch.optim import adafactor, adamw, grad_compression
    from repro_torch.parallel import sharding

    undo = []
    for mod in (sharding, adamw, adafactor, grad_compression):
        for name in HELPERS:
            fn = getattr(mod, name, None)
            if fn is None:
                continue

            @functools.wraps(fn)
            def timed(*a, _fn=fn, _name=name, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    spent[_name] += time.perf_counter() - t0

            undo.append((mod, name, fn))
            setattr(mod, name, timed)
    return undo


def _timed_gather(spent: collections.Counter) -> list:
    """Wrap ``LayerShards.gather``, where the package has it, to add its
    host seconds to ``spent["gather"]``; returns what to put back."""
    from repro_torch.parallel import sharding

    cls = getattr(sharding, "LayerShards", None)
    if cls is None:
        return []
    fn = cls.gather

    @functools.wraps(fn)
    def timed(self):
        t0 = time.perf_counter()
        try:
            return fn(self)
        finally:
            spent["gather"] += time.perf_counter() - t0

    cls.gather = timed
    return [(cls, "gather", fn)]


def ab(base: str, change: str, steps: int) -> dict:
    """This script's result against each checkout's ``src`` in turns: base,
    change, change, base; each side's median of its runs' medians."""
    runs = []
    for side, root in (("base", base), ("change", change),
                       ("change", change), ("base", base)):
        with tempfile.NamedTemporaryFile(suffix=".json") as f:
            env = {**os.environ,
                   "PYTHONPATH": os.path.join(os.path.abspath(root), "src")}
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--steps",
                 str(steps), "--json", f.name], env=env, capture_output=True,
                text=True)
            if proc.returncode:
                raise RuntimeError(f"{side} ({root}) failed:\n"
                                   f"{proc.stdout[-2000:]}\n"
                                   f"{proc.stderr[-4000:]}")
            runs.append({"side": side, "root": root,
                         **json.load(open(f.name))})
    sides = {}
    for side in ("base", "change"):
        mine = [r for r in runs if r["side"] == side]
        sides[side] = {
            key: {kind: statistics.median(v for r in mine
                                          for v in r[key][kind])
                  for kind in mine[0][key]}
            for key in ("median_ms", "peak_gb")}
    ratio = {kind: sides["change"]["median_ms"][kind]
             / sides["base"]["median_ms"][kind]
             for kind in sides["base"]["median_ms"]}
    peak_diff = {kind: sides["change"]["peak_gb"][kind]
                 - sides["base"]["peak_gb"][kind]
                 for kind in sides["base"]["peak_gb"]}
    return {"card": runs[0]["card"], "order": [r["side"] for r in runs],
            "sides": sides, "change_over_base_ms": ratio,
            "change_minus_base_peak_gb": peak_diff, "runs": runs}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--json", help="also write the result here")
    parser.add_argument("--ab", nargs=2, metavar=("BASE", "CHANGE"),
                        help="run against two checkouts in turns")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.ab:
        out = ab(*args.ab, args.steps)
        print(json.dumps(out), flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(out, f, indent=1)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data import SyntheticLMStream, device_put_batch
    from repro_torch.launch.mesh import (make_mesh_compat,
                                         release_process_group)
    from repro_torch.launch.steps import (build_train_step,
                                          init_train_state, place)
    from repro_torch.launch.train import train_step
    from repro_torch.models import transformer as MT
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel.layouts import rules_for
    from repro_torch.parallel.sharding import use_mesh

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[:1]
    cfg = get_config("llama3.2-3b")
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    state = init_train_state(cfg)
    model = MT.TransformerLM.from_stacked(cfg, state["params"])
    grads = MT.bind_stacked_grads(model, state["params"])

    def batch(rows, i):
        shape = ShapeSpec("train", "train", 2048, rows)
        return device_put_batch(SyntheticLMStream(cfg, shape).batch_at(i),
                                "cuda")

    def mesh_step(accum, rows):
        shape = ShapeSpec("train", "train", 2048, rows)
        c = dataclasses.replace(cfg, accum=accum)
        rules = rules_for(c, shape, mesh)
        prog = build_train_step(c, shape, mesh, rules)
        dstate = place(state, prog.in_shardings[0])
        step = prog.jitted()

        def run(b):
            with use_mesh(mesh, rules):
                step(dstate, b)
        return run

    runs = {"single": lambda b: train_step(cfg, model, state, grads, b,
                                           AdamWConfig()),
            "mesh1": mesh_step(1, 2), "mesh4": mesh_step(cfg.accum, 8)}
    rows = {"single": 2, "mesh1": 2, "mesh4": 8}
    spent: collections.Counter = collections.Counter()
    undo = _timed_helpers(spent) + _timed_gather(spent)
    from repro_torch.parallel import sharding
    stats = getattr(sharding, "GATHER", None)
    ms: dict = {k: [] for k in runs}
    helper_s: dict = {k: [] for k in runs}
    gather_s: dict = {k: [] for k in runs}
    peak: dict = {k: [] for k in runs}
    gathers: dict = {}
    for name in ("single", "mesh1", "mesh4", "mesh4", "mesh1", "single"):
        b = batch(rows[name], 0)
        runs[name](b)  # untimed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if stats is not None:
            stats.reset()
        times, helpers, gather = [], [], []
        for i in range(args.steps):
            b = batch(rows[name], i + 1)
            spent.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name](b)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            gather.append(1e3 * spent.pop("gather", 0.0))
            helpers.append(1e3 * sum(spent.values()))
        ms[name].append(statistics.median(times))
        helper_s[name].append(statistics.median(helpers))
        gather_s[name].append(statistics.median(gather))
        peak[name].append(torch.cuda.max_memory_allocated() / 1e9)
        if stats is not None:
            gathers[name] = {k: v / args.steps
                             for k, v in stats.counts().items()}
    for mod, name, fn in undo:
        setattr(mod, name, fn)

    b = batch(8, 99)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runs["mesh4"](b)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0.0)
                or getattr(e, "self_cuda_time_total", 0.0))

    # the kernels' own time: the events on the card, less CUPTI's marks of
    # launches that waited for room in the card's queue
    from torch.autograd import DeviceType
    device_ms = sum(dev_us(e) for e in events
                    if e.device_type == DeviceType.CUDA
                    and e.key != "Command Buffer Full") / 1e3
    nccl_ms = sum(dev_us(e) for e in events if "nccl" in e.key.lower()) / 1e3
    top_dev = sorted(events, key=dev_us, reverse=True)[:8]
    top_host = sorted(events, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:8]
    out = {"card": card[0] if card else "not read", "arch": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype, "steps": args.steps,
           "median_ms": ms, "mesh_helpers_host_ms": helper_s,
           "gather_host_ms": gather_s, "peak_gb": peak,
           "gathers_per_step": gathers,
           "rows": rows, "accum": {"single": 1, "mesh1": 1,
                                   "mesh4": cfg.accum},
           "profiled_mesh4": {
               "wall_ms": wall, "device_ms": device_ms,
               "device_busy_share": device_ms / wall, "nccl_ms": nccl_ms,
               "top_device_us": [[e.key[:60], dev_us(e), e.count]
                                 for e in top_dev],
               "top_host_us": [[e.key[:60], e.self_cpu_time_total, e.count]
                               for e in top_host]}}
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    release_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
