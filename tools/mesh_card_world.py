"""The mesh train and prefill steps sharded over four cards, against one.

    PYTHONPATH=src python3 tools/mesh_card_world.py [--layers N]
        [--steps N] [--json PATH]
    PYTHONPATH=src python3 tools/mesh_card_world.py --device cpu

llama3.2-3b at full width, ``--layers`` deep, in f32, ``build_train_step``
at the config's own accum (4) over 8 rows of 2048 tokens, AdamW at lr
3e-4, from ``init_train_state``'s seeded state: first on a 1x1 mesh on one
card (this process), then, for each of ``MESHES`` ("data" x "model"),
in 4 processes, one card each, over NCCL (``tcp://localhost``), the state
laid out by the rules. Each block gathers its layer from the shards over
"data" and reduce-scatters its gradient back (``parallel/sharding.py``
``LayerShards``), and computes its heads, ffn columns and vocab rows over
"model" (``model_parallel``: an all-reduce where a split block leaves,
and where its input's gradient comes back). After the first step the
sharded run's state, gathered whole, is held to the one-card run's: the
loss and AdamW's grad norm within ``LOSS_RTOL``, the first moment (the
clipped gradient times 1 - b1) within ``GRAD_RTOL`` of each leaf's max,
and the parameters but for a share ``OUTLIERS`` of a leaf within
``GRAD_RTOL``, every element within ``FLIP`` = 2 lr: AdamW's first step
moves an element by lr * g / (|g| + eps), so where g is near zero the two
runs' roundings may set it anywhere in [-lr, lr]. Then ``--steps`` more
steps on each side are timed. Before the steps, the seeded parameters
run ``build_prefill_step`` over 2 rows of 512 tokens, whose logits (each
model rank's vocab chunk) are held within ``LOGITS_RTOL`` of the largest
of one card's. Each rank reports its peak device memory, its local
state's and gradient buffers' bytes against the whole model's, the
gather's calls, bytes copied and collectives a step, the model region's
all-reduces and bytes a step, the step's ms and tokens/s. Prints one JSON
line, with the cards' name and power limit; exits non-zero if a check
fails. Needs four CUDA cards.

``--device cpu`` rehearses the same path on the CPU: the reduced config
(8 rows of 32 tokens, the prefill 2 of 32), gloo in place of NCCL.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANKS = 4
# the ("data", "model") meshes of the four ranks: both axes, and the
# model axis alone, where nothing is gathered
MESHES = ((2, 2), (1, 4))
LR = 3e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
OUTLIERS = 1e-3
# the most AdamW's first step can set two runs' element apart, and f32
# rounding of the parameter beside it
FLIP = 2 * LR * (1 + 1e-3)
# the prefill's logits against one card's, of their largest |value|
LOGITS_RTOL = 1e-5


def _setup(args):
    """(config, shape, the first batch, later batches) for ``args``."""
    from repro_torch.configs import ShapeSpec, get_config, reduced
    from repro_torch.data import SyntheticLMStream

    cfg = get_config("llama3.2-3b")
    if args.device == "cpu":
        cfg = reduced(cfg)
    else:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    cfg = dataclasses.replace(cfg, dtype="float32", accum=4)
    cpu = args.device == "cpu"
    shape = ShapeSpec("mesh", "train", 32 if cpu else 2048, 8)
    stream = SyntheticLMStream(cfg, shape)
    pshape = ShapeSpec("mesh_prefill", "prefill", 32 if cpu else 512, 2)
    pre = SyntheticLMStream(cfg, pshape).batch_at(0)
    return cfg, shape, [stream.batch_at(i) for i in range(1 + args.steps)], \
        pshape, {"tokens": pre["tokens"]}


def _run(args, device: str, mesh_shape: tuple) -> dict:
    """The steps on a mesh of ``mesh_shape`` over this process group; the
    first step's state whole (on every rank) and this rank's readings."""
    from repro_torch._tree import flatten, leaves
    from repro_torch.data import device_put_batch
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_train_step,
                                          init_train_state, place)
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel.layouts import rules_for
    from repro_torch.parallel.sharding import (GATHER, MODEL, full, local,
                                               use_mesh)

    cfg, shape, batches, pshape, pbatch = _setup(args)
    mesh = make_mesh_compat(mesh_shape, ("data", "model"), device=device)
    rules = rules_for(cfg, shape, mesh)
    prog = build_train_step(cfg, shape, mesh, rules,
                            opt_cfg=AdamWConfig(lr=LR))
    state = place(init_train_state(cfg, device=device),
                  prog.in_shardings[0])
    cuda = device != "cpu"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    # the prefill on the seeded parameters, the same on every side (after
    # a step, AdamW's flips near g = 0 would set them apart)
    prefill = build_prefill_step(cfg, pshape, mesh,
                                 rules_for(cfg, pshape, mesh))
    with use_mesh(mesh, rules):
        logits = prefill.jitted()(state["params"],
                                  device_put_batch(pbatch, device))
    logits = full(logits).to("cpu", copy=True)
    step = prog.jitted()
    ms, counts = [], []
    for i, b in enumerate(batches):
        b = device_put_batch(b, device)
        GATHER.reset()
        MODEL.reset()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with use_mesh(mesh, rules):
            state, m = step(state, b)
        if cuda:
            torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        counts.append({**GATHER.counts(), **{
            f"model_{k}": v for k, v in MODEL.counts().items()}})
        if i == 0:
            metrics = {k: float(v) for k, v in m.items()}
            first = {"/".join(map(str, p)): full(v).to("cpu", copy=True)
                     for p, v in flatten({"params": state["params"],
                                          "m": state["opt"]["m"]})}
    params = leaves(state["params"])
    whole_gb = sum(p.numel() * p.element_size() for p in params) / 1e9
    local_gb = sum(local(t).nbytes for t in leaves(state)) / 1e9
    steady = statistics.median(ms[1:]) if len(ms) > 1 else None
    return {"first": first, "metrics": metrics, "logits": logits,
            "readings": {
        "step_ms": ms, "median_ms_after_first": steady,
        "tokens_per_s": (1e3 * shape.global_batch * shape.seq_len / steady
                         if steady else None),
        "gathers_per_step": counts[-1],
        "gathered_gb_per_step": counts[-1]["bytes_copied"] / 1e9,
        "local_state_gb": local_gb, "local_params_gb": sum(
            local(p).nbytes for p in params) / 1e9,
        "whole_params_gb": whole_gb,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
        "loss": metrics["loss"], "grad_norm": metrics["grad_norm"]}}


def _rank(rank: int, args, port: int, out_path: str,
          mesh_shape: tuple) -> None:
    cuda = args.device != "cpu"
    if cuda:
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}",
        rank=rank, world_size=RANKS, timeout=datetime.timedelta(seconds=300))
    try:
        res = _run(args, f"cuda:{rank}" if cuda else "cpu", mesh_shape)
        every = [None] * RANKS
        dist.all_gather_object(every, res["readings"])
        if rank == 0:
            torch.save({"first": res["first"], "metrics": res["metrics"],
                        "logits": res["logits"], "ranks": every}, out_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _held(got: dict, want: dict) -> tuple[list, dict]:
    """The sharded first step against the one-card one."""
    bad, worst = [], {}
    scale = float(want["logits"].abs().max())
    worst["logits"] = float((got["logits"].double()
                             - want["logits"].double()).abs().max()) / scale
    if worst["logits"] > LOGITS_RTOL:
        bad.append(f"prefill logits {worst['logits']} of their max")
    for k in ("loss", "grad_norm"):
        rel = abs(got["metrics"][k] - want["metrics"][k]) / abs(
            want["metrics"][k])
        worst[k] = rel
        if rel > LOSS_RTOL:
            bad.append(f"{k} {got['metrics'][k]} vs {want['metrics'][k]}")
    for path, w in want["first"].items():
        diff = (got["first"][path].double() - w.double()).abs()
        err = diff / w.abs().max().clamp_min(1e-30).double()
        kind = path.split("/")[0]
        worst[kind] = max(worst.get(kind, 0.0), float(err.max()))
        share = float((err > GRAD_RTOL).double().mean())
        worst[kind + "_share"] = max(worst.get(kind + "_share", 0.0), share)
        if kind == "m" and float(err.max()) > GRAD_RTOL:
            bad.append(f"{path}: {float(err.max())} of its max")
        if kind == "params":
            worst["params_over_lr"] = max(worst.get("params_over_lr", 0.0),
                                          float(diff.max()) / LR)
            if share > OUTLIERS or float(diff.max()) > FLIP:
                bad.append(f"{path}: {share} beyond {GRAD_RTOL} of its max, "
                           f"the worst {float(diff.max()) / LR} lr")
    return bad, worst


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--layers", type=int, default=4)
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--json", help="also write the result here")
    args = parser.parse_args()
    cuda = args.device != "cpu"
    if cuda and torch.cuda.device_count() < RANKS:
        raise SystemExit(f"needs {RANKS} CUDA cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = (subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines() if cuda else ["cpu"])
    from repro_torch.launch.mesh import release_process_group

    one = _run(args, "cuda:0" if cuda else "cpu", (1, 1))
    release_process_group()
    if cuda:
        torch.cuda.empty_cache()
    meshes, bad = {}, []
    for mesh_shape in MESHES:
        name = "x".join(map(str, mesh_shape))
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "sharded.pt")
            mp.spawn(_rank, args=(args, port, path, mesh_shape),
                     nprocs=RANKS, join=True)
            sharded = torch.load(path)
        fails, worst = _held(sharded, one)
        bad += [f"{name}: {f}" for f in fails]
        meshes[name] = {"mesh": {"data": mesh_shape[0],
                                 "model": mesh_shape[1]},
                        "ranks": sharded["ranks"],
                        "worst_over_leaf_max": worst, "failures": fails}
    out = {"cards": card, "arch": "llama3.2-3b", "dtype": "float32",
           "layers": args.layers if cuda else "reduced", "accum": 4,
           "one_card": one["readings"], "meshes": meshes,
           "limits": {"loss": LOSS_RTOL, "grad": GRAD_RTOL,
                      "outliers": OUTLIERS, "outlier_abs": FLIP,
                      "logits": LOGITS_RTOL},
           "failures": bad}
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
