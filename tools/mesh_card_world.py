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
"model" (``model_parallel``); the residual stream between the blocks is
each model rank's rows of the sequence (Megatron-SP, ``seq_parallel``:
an all-gather of the sequence where a block enters, a reduce-scatter into
the rows where it leaves, and the reverse for the gradient), so the
norms, the residual adds and the block inputs remat keeps are 1/model a
rank. After the first step the
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
all-reduces and bytes a step, its all-gathers and reduce-scatters of the
sequence and the GB of the whole sequence they move a step, the most
bytes of block inputs remat held at once (the tensors handed to
``torch.utils.checkpoint``, each counted once while alive), the step's
ms and tokens/s. Prints one JSON
line, with the cards' name and power limit; exits non-zero if a check
fails. Needs four CUDA cards.

``--device cpu`` rehearses the same path on the CPU: the reduced config
(8 rows of 32 tokens, the prefill 2 of 32), gloo in place of NCCL.

    PYTHONPATH=src python3 tools/mesh_card_world.py --serve [--json PATH]

``--serve`` runs the serve step instead: llama3.2-3b at full width and
depth, ``SERVE``'s slots and cache, from one seeded state (every cache row
a seeded draw, the slots' positions spread over the cache), on one card
through ``decode_step`` and, for each of ``MESHES``, on four through
``build_serve_step`` (the caches split along their sequence over "model",
flash-decode; the MLP and the vocab over "model"), the parameters and
the state laid out once. First a check in f32 on an f32 cache:
``SERVE["check_steps"]`` greedy steps, each side feeding its own argmax,
whose logits must lie within ``SERVE_F32_RTOL`` of the largest of one
card's and whose tokens must be the same; the same on the cache's own
bf16, whose gap is reported (``SERVE_RUNS`` says why). Then the timed
run in bf16:
``SERVE["warm"]`` steps, then ``SERVE["steps"]`` timed, fed one seeded
token sequence, whose logits must lie within ``SERVE_BF16_RTOL`` (the
argmax's agreement is reported). Each rank reports ms a step, the cache's
GB it holds, its peak GB, the GB gathered a step (the layer gather's whole
leaves, ``GATHER``, and any state leaf a DTensor redistribution gathers)
and the all-reduces a step over the model region and the caches' shards
(``MODEL``). Run with another checkout's ``src`` on ``PYTHONPATH`` (the
parent commit's, unpacked by ``git archive``), it measures that one's
serve step on the same cards.

    PYTHONPATH=src python3 tools/mesh_card_world.py --seq-inner [--json PATH]

``--seq-inner`` runs the prefill step alone: llama3.2-3b at full width,
``--layers`` deep, in f32, over ``SEQ_INNER``'s rows of tokens, from
seeded parameters (the same on every side), on a 1x1 mesh on one card and,
for each of ``MESHES``, on four under each of ``LAYOUTS``: the rules'
override ``seq_inner="model"`` (the blocks keep the sequence on "model"
inside: attention over each rank's query rows against the all-gathered
K/V, B3 at the rows' offset; the MLP and the head on the rows, their
leaves whole; the logits each rank's rows) and ``rules_for``'s own
layout (Megatron-SP: the heads, ffn and vocab split, each block's input
all-gathered and its output reduce-scattered). Each rank's logits are
held to the same part of one card's (kept on the host in a file the ranks
map) within ``LOGITS_RTOL`` of their largest; each rank reports the
prefill's ms (``SEQ_INNER["reps"]`` timed after one), its peak GB, the
layer gather's GB, the model region's all-gathers and reduce-scatters of
the sequence (K and V under ``seq_inner``) with their GB, and its
all-reduces.

    PYTHONPATH=src python3 tools/mesh_card_world.py [--serve | --seq-inner]
        --dryrun [--json PATH]

``--dryrun`` adds the dry run's prediction (``repro_torch.launch.dryrun``
``dry_run``, each rank of each mesh on a fake world, in a child process on
the host: ``--predict``) beside each rank's measurement: the collectives
one step issues (the train step's first, the first prefill, the bf16
serve run's first step), each ``(kind, result bytes, group size)`` and
how many, recorded on the cards by the dry run's own billing
(``dryrun.IssuedCollectives``), which must be equal; and the peak's
ratio, the prediction's (arguments, temporaries and outputs less
aliases) over the card's ``max_memory_allocated``, reported.
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
import weakref

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
# --serve: the slots, cache rows, warm-up, timed and checked steps
SERVE = dict(slots=8, cache=8192, warm=2, steps=16, check_steps=3)
# its logits against one card's, of their largest |value|: in f32 the
# split changes the order of the f32 sums (the MLP's and the vocab's
# partial sums, the shards' softmax sums and partial outputs) and can flip
# a bf16 rounding of an attention probability or output where the two
# orders straddle it (the cache is bf16), a bf16 step of one element in a
# layer; in bf16 each rank's partial sums are rounded to bf16 before the
# all-reduce, a bf16-sized change of each split block's output, which a
# bf16 model turns into 2-3% of its logits (PERF.md, section 6)
SERVE_F32_RTOL = 1e-4
SERVE_BF16_RTOL = 5e-2
# --serve's runs: (the model's dtype, the cache's; None: its own, bf16).
# "float32" holds SERVE_F32_RTOL where nothing rounds to bf16 (an f32
# cache); "float32_bf16_cache" keeps the decode cache's own bf16, where an
# f32 ulp apart in a new K/V row can round it a bf16 ulp apart, which 28
# layers carry into the logits (PERF.md, section 6: 1.8e-3 of their max
# on (2, 2) with the batch split alone): its gap is reported, not held;
# "bfloat16" is the timed run
SERVE_RUNS = {"float32": ("float32", torch.float32),
              "float32_bf16_cache": ("float32", None),
              "bfloat16": ("bfloat16", None)}
# --seq-inner: the prefill's rows and tokens (the CPU's: 2 of 32), and the
# timed runs after a first one
SEQ_INNER = dict(rows=2, tokens=8192, reps=3)
# --seq-inner's layouts: rules_for's own overrides of each
LAYOUTS = {"seq_inner": {"seq_inner": "model"}, "sp": None}
# --dryrun: the prediction child's limit
PREDICT_TIMEOUT_S = 600


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


class _SavedInputs:
    """Within: the most bytes of tensors handed to
    ``torch.utils.checkpoint`` alive at once (``peak``), each counted once
    until it is collected: remat's block inputs."""

    def __enter__(self):
        import torch.utils.checkpoint as ckpt

        self.alive, self.peak, self.held = 0, 0, {}
        self._real = real = ckpt.checkpoint

        def checkpoint(fn, *args, **kwargs):
            for a in args:
                if isinstance(a, torch.Tensor) and id(a) not in self.held:
                    self.held[id(a)] = a.nbytes
                    self.alive += a.nbytes
                    self.peak = max(self.peak, self.alive)
                    weakref.finalize(a, self._gone, id(a))
            return real(fn, *args, **kwargs)
        ckpt.checkpoint = checkpoint
        return self

    def _gone(self, key: int) -> None:
        self.alive -= self.held.pop(key)

    def __exit__(self, *exc):
        import torch.utils.checkpoint as ckpt

        ckpt.checkpoint = self._real


def _run(args, device: str, mesh_shape: tuple) -> dict:
    """The steps on a mesh of ``mesh_shape`` over this process group; the
    first step's state whole (on every rank) and this rank's readings."""
    from repro_torch._tree import flatten, leaves
    from repro_torch.data import device_put_batch
    from repro_torch.launch.dryrun import IssuedCollectives
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
        with use_mesh(mesh, rules), _SavedInputs() as saved, \
                IssuedCollectives(args.dryrun and i == 0) as issued:
            state, m = step(state, b)
        if cuda:
            torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            first_issued = issued.report()
        counts.append({**GATHER.counts(), **{
            f"model_{k}": v for k, v in MODEL.counts().items()},
            "remat_saved_bytes": saved.peak})
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
        "seq_all_gather_gb_per_step":
            counts[-1]["model_gathered_bytes"] / 1e9,
        "seq_reduce_scatter_gb_per_step":
            counts[-1]["model_scattered_bytes"] / 1e9,
        "remat_saved_gb": counts[-1]["remat_saved_bytes"] / 1e9,
        "local_state_gb": local_gb, "local_params_gb": sum(
            local(p).nbytes for p in params) / 1e9,
        "whole_params_gb": whole_gb,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
        "issued": first_issued,
        "loss": metrics["loss"], "grad_norm": metrics["grad_norm"]}}


def _prefill_setup(args):
    """(config, shape, tokens) of ``--seq-inner``'s prefill."""
    from repro_torch.configs import ShapeSpec, get_config, reduced
    from repro_torch.data import SyntheticLMStream

    cfg = get_config("llama3.2-3b")
    cpu = args.device == "cpu"
    cfg = reduced(cfg) if cpu else dataclasses.replace(
        cfg, num_layers=args.layers)
    cfg = dataclasses.replace(cfg, dtype="float32")
    shape = ShapeSpec("seq_inner", "prefill",
                      32 if cpu else SEQ_INNER["tokens"], SEQ_INNER["rows"])
    return cfg, shape, SyntheticLMStream(cfg, shape).batch_at(0)["tokens"]


def _prefill_run(args, device: str, mesh_shape: tuple, layout: str,
                 want_path: str = None) -> dict:
    """``build_prefill_step`` on a mesh of ``mesh_shape`` under
    ``LAYOUTS[layout]``: this rank's readings, and its logits against the
    same part of one card's (``want_path``, saved whole; None: the logits
    are returned, whole)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    from repro_torch.data import device_put_batch
    from repro_torch.launch.dryrun import IssuedCollectives
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.launch.steps import build_prefill_step, place
    from repro_torch.models import transformer as T
    from repro_torch.parallel.layouts import rules_for
    from repro_torch.parallel.sharding import GATHER, MODEL, full, use_mesh

    cfg, shape, tokens = _prefill_setup(args)
    mesh = make_mesh_compat(mesh_shape, ("data", "model"), device=device)
    rules = rules_for(cfg, shape, mesh, LAYOUTS[layout])
    prog = build_prefill_step(cfg, shape, mesh, rules)
    gen = torch.Generator(device=device).manual_seed(0)
    params = place(T.init_param_tree(cfg, gen, device=device),
                   prog.in_shardings[0])
    batch = device_put_batch({"tokens": tokens}, device)
    run = prog.jitted()
    cuda = device != "cpu"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    ms = []
    for i in range(1 + SEQ_INNER["reps"]):
        GATHER.reset()
        MODEL.reset()
        logits = None
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with use_mesh(mesh, rules), \
                IssuedCollectives(args.dryrun and i == 0) as rec:
            logits = run(params, batch)
        if i == 0:
            issued = rec.report()
        if cuda:
            torch.cuda.synchronize(device)
        ms.append(1e3 * (time.perf_counter() - t0))
    counts = {**GATHER.counts(), **{f"model_{k}": v
                                    for k, v in MODEL.counts().items()}}
    readings = {
        "step_ms": ms, "median_ms_after_first": statistics.median(ms[1:]),
        "tokens_per_s": 1e3 * shape.global_batch * shape.seq_len
        / statistics.median(ms[1:]),
        "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                    if cuda else None),
        "layer_gathered_gb": counts["bytes_copied"] / 1e9,
        "seq_all_gathers": counts["model_all_gathers"],
        "seq_all_gather_gb": counts["model_gathered_bytes"] / 1e9,
        "seq_reduce_scatters": counts["model_reduce_scatters"],
        "seq_reduce_scatter_gb": counts["model_scattered_bytes"] / 1e9,
        "model_all_reduces": counts["model_all_reduces"],
        "counts": counts, "issued": issued,
        "logits_split_dims": [getattr(p, "dim", None)
                              for p in logits.placements]}
    if want_path is None:
        return {"readings": readings,
                "logits": full(logits).to("cpu", copy=True)}
    want = torch.load(want_path, mmap=True)
    part, offset = compute_local_shape_and_global_offset(
        tuple(logits.shape), mesh, logits.placements)
    mine = want[tuple(slice(o, o + n) for o, n in zip(offset, part))]
    readings["max_abs_err"] = float((logits.to_local().double().cpu()
                                     - mine.double()).abs().max())
    return {"readings": readings}


def _prefill_rank(rank: int, args, port: int, out_path: str,
                  mesh_shape: tuple, layout: str, want_path: str) -> None:
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
        res = _prefill_run(args, f"cuda:{rank}" if cuda else "cpu",
                           mesh_shape, layout, want_path)
        every = [None] * RANKS
        dist.all_gather_object(every, res["readings"])
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(every, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def seq_inner_main(args, card) -> int:
    """``--seq-inner``: one card, then each mesh under each layout."""
    from repro_torch.launch.mesh import release_process_group

    cuda = args.device != "cpu"
    child = _start_prediction(args) if args.dryrun else None
    one = _prefill_run(args, "cuda:0" if cuda else "cpu", (1, 1),
                       "seq_inner")
    release_process_group()
    if cuda:
        torch.cuda.empty_cache()
    scale = float(one["logits"].abs().max())
    meshes, bad = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        want_path = os.path.join(tmp, "one_card_logits.pt")
        torch.save(one.pop("logits"), want_path)
        for mesh_shape in MESHES:
            for layout in LAYOUTS:
                name = "x".join(map(str, mesh_shape)) + "/" + layout
                with socket.socket() as s:
                    s.bind(("localhost", 0))
                    port = s.getsockname()[1]
                path = os.path.join(tmp, "ranks.json")
                mp.spawn(_prefill_rank, args=(args, port, path, mesh_shape,
                                              layout, want_path),
                         nprocs=RANKS, join=True)
                with open(path) as f:
                    ranks = json.load(f)
                worst = max(r["max_abs_err"] for r in ranks) / scale
                fails = ([f"{name}: logits {worst} of their max, over "
                          f"{LOGITS_RTOL}"] if worst > LOGITS_RTOL else [])
                bad += fails
                meshes[name] = {"mesh": {"data": mesh_shape[0],
                                         "model": mesh_shape[1]},
                                "layout": layout,
                                "rules_overrides": LAYOUTS[layout],
                                "ranks": ranks, "logits_over_max": worst,
                                "failures": fails}
    if child is not None:
        bad += _against(child, meshes)
    _, shape, _ = _prefill_setup(args)
    out = {"cards": card, "arch": "llama3.2-3b", "mode": "seq_inner",
           "dtype": "float32", "layers": args.layers if cuda else "reduced",
           "tokens": [shape.global_batch, shape.seq_len],
           "one_card": one["readings"], "meshes": meshes,
           "limits": {"logits": LOGITS_RTOL}, "failures": bad}
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 1 if bad else 0


def _serve_cfg(args, dtype: str):
    from repro_torch.configs import ShapeSpec, get_config, reduced

    cfg = get_config("llama3.2-3b")
    cpu = args.device == "cpu"
    if cpu:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    slots, cache = SERVE["slots"], 64 if cpu else SERVE["cache"]
    return cfg, ShapeSpec("serve", "decode", cache, slots)


def _serve_state(cfg, shape, device: str, cache_dtype=None) -> dict:
    """The seeded decode state, the same on every rank: every cache row a
    normal draw (seed 1), the slots' positions spread over the cache; the
    cache in ``cache_dtype`` (None: its own, bf16)."""
    from repro_torch.models import transformer as T

    gen = torch.Generator(device=device).manual_seed(1)
    state = T.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                device=device)
    if cache_dtype is not None:
        state["kv"] = {k: v.to(cache_dtype) for k, v in state["kv"].items()}
    for leaf in state["kv"].values():
        for i in range(leaf.shape[0]):  # a layer at a time
            leaf[i].copy_(torch.randn(leaf[i].shape, generator=gen,
                                      device=device))
    room = shape.seq_len - SERVE["warm"] - SERVE["steps"] - 1
    state["pos"].copy_(torch.arange(shape.global_batch, device=device)
                       * (room // shape.global_batch) + 3)
    return state


def _serve_run(args, device: str, mesh_shape) -> dict:
    """The f32 check and the timed bf16 run on one card (``mesh_shape``
    None: ``decode_step``) or on a mesh (``build_serve_step``); the
    logits (whole) and tokens of each, and this rank's readings."""
    from repro_torch._tree import flatten, leaves
    from repro_torch.launch.dryrun import IssuedCollectives
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as SH

    cuda = device != "cpu"
    gathered = [0]
    if mesh_shape is not None:
        from torch.distributed.tensor import DTensor

        from repro_torch.launch.mesh import make_mesh_compat
        from repro_torch.launch.steps import build_serve_step, place
        from repro_torch.parallel.layouts import rules_for

        mesh = make_mesh_compat(mesh_shape, ("data", "model"), device=device)
        real = DTensor.redistribute

        def redistribute(t, *a, **k):  # a state leaf gathered: its bytes
            out = real(t, *a, **k)
            grew = out.to_local().nbytes - t.to_local().nbytes
            gathered[0] += max(grew, 0)
            return out
        DTensor.redistribute = redistribute

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    out = {}
    try:
        for run_name, (dtype, cache_dtype) in SERVE_RUNS.items():
            cfg, shape = _serve_cfg(args, dtype)
            gen = torch.Generator(device=device).manual_seed(0)
            params = T.init_param_tree(cfg, gen, device=device)
            state = _serve_state(cfg, shape, device, cache_dtype)
            record = IssuedCollectives(args.dryrun
                                       and run_name == "bfloat16"
                                       and mesh_shape is not None)
            if mesh_shape is None:
                model = T.TransformerLM.from_stacked(cfg, params)

                def step(tokens, state):
                    return T.decode_step(cfg, model, state, tokens)
            else:
                rules = rules_for(cfg, shape, mesh)
                prog = build_serve_step(cfg, shape, mesh, rules)
                # laid out once, as a server keeps them; the whole let go
                params = place(params, prog.in_shardings[0])
                state = place(state, prog.in_shardings[1])
                run = prog.jitted()

                def step(tokens, state):
                    with SH.use_mesh(mesh, rules), record:
                        logits, state = run(params, state, tokens)
                    record.on = False  # the first step's alone
                    return SH.full(logits), state
            check = run_name != "bfloat16"
            n = SERVE["check_steps"] if check else (SERVE["warm"]
                                                    + SERVE["steps"])
            feed = torch.randint(0, cfg.vocab_size, (n, shape.global_batch),
                                 generator=torch.Generator().manual_seed(2),
                                 dtype=torch.int32).to(device)
            tokens = feed[0]
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            logits_seen, ms, counts = [], [], []
            for i in range(n):
                SH.GATHER.reset()
                SH.MODEL.reset()
                gathered[0] = 0
                sync()
                t0 = time.perf_counter()
                logits, state = step(tokens, state)
                sync()
                ms.append(1e3 * (time.perf_counter() - t0))
                counts.append({"gathered_gb": (SH.GATHER.bytes_copied
                                               + gathered[0]) / 1e9,
                               "model_all_reduces": SH.MODEL.all_reduces})
                logits_seen.append(logits.to("cpu", copy=True))
                tokens = (logits.argmax(-1).to(torch.int32) if check
                          else feed[(i + 1) % n])
            timed = ms if check else ms[SERVE["warm"]:]
            caches = [t for p, t in flatten(state) if p[0] == "kv"]
            out[run_name] = {
                "logits": torch.stack(logits_seen),
                "readings": {
                    "step_ms": ms, "issued": record.report(),
                    "median_ms": statistics.median(timed),
                    "cache_gb": sum(SH.local(t).nbytes for t in caches) / 1e9,
                    "whole_cache_gb": sum(t.numel() * t.element_size()
                                          for t in caches) / 1e9,
                    "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                                if cuda else None),
                    "per_step": counts[-1],
                    "local_params_gb": sum(SH.local(p).nbytes
                                           for p in leaves(params)) / 1e9}}
            del params, state, step
            if mesh_shape is None:
                del model
            else:
                del prog, run
    finally:
        if mesh_shape is not None:
            DTensor.redistribute = real
    return out


def _serve_rank(rank: int, args, port: int, out_path: str,
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
        res = _serve_run(args, f"cuda:{rank}" if cuda else "cpu",
                         mesh_shape)
        every = [None] * RANKS
        dist.all_gather_object(every, {k: v["readings"]
                                       for k, v in res.items()})
        if rank == 0:
            torch.save({"logits": {k: v["logits"] for k, v in res.items()},
                        "ranks": every}, out_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _serve_held(got: dict, want: dict) -> tuple[list, dict]:
    """A mesh's logits against one card's: the f32 check's (an f32 cache)
    within SERVE_F32_RTOL and its greedy tokens equal; the bf16 run's
    within SERVE_BF16_RTOL; the f32 model's on its bf16 cache reported
    (the argmax's agreement of each too)."""
    bad, worst = [], {}
    for run, rtol in (("float32", SERVE_F32_RTOL),
                      ("float32_bf16_cache", None),
                      ("bfloat16", SERVE_BF16_RTOL)):
        g, w = got[run].float(), want[run].float()
        err = float((g - w).abs().max()) / float(w.abs().max())
        worst[run] = err
        agree = (g.argmax(-1) == w.argmax(-1)).double().mean()
        worst[run + "_argmax_agreement"] = float(agree)
        if rtol is not None and err > rtol:
            bad.append(f"{run} logits {err} of their max, over {rtol}")
        if run == "float32" and agree < 1:
            bad.append(f"f32 greedy tokens differ ({float(agree)} agree)")
    return bad, worst


def serve_main(args, card) -> int:
    from repro_torch.launch.mesh import release_process_group

    child = _start_prediction(args) if args.dryrun else None
    device = "cuda:0" if args.device != "cpu" else "cpu"
    one = _serve_run(args, device, None)
    release_process_group()
    if args.device != "cpu":
        torch.cuda.empty_cache()
    want = {k: v["logits"] for k, v in one.items()}
    meshes, bad = {}, []
    for mesh_shape in MESHES:
        name = "x".join(map(str, mesh_shape))
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "serve.pt")
            mp.spawn(_serve_rank, args=(args, port, path, mesh_shape),
                     nprocs=RANKS, join=True)
            sharded = torch.load(path)
        fails, worst = _serve_held(sharded["logits"], want)
        bad += [f"{name}: {f}" for f in fails]
        meshes[name] = {"mesh": {"data": mesh_shape[0],
                                 "model": mesh_shape[1]},
                        "ranks": sharded["ranks"],
                        "worst_over_max": worst, "failures": fails}
    if child is not None:
        bad += _against(child, meshes, "bfloat16")
    import repro_torch
    out = {"cards": card, "arch": "llama3.2-3b", "mode": "serve",
           "package": os.path.dirname(repro_torch.__file__),
           "serve": SERVE, "one_card": {k: v["readings"]
                                        for k, v in one.items()},
           "meshes": meshes,
           "limits": {"float32": SERVE_F32_RTOL, "float32_bf16_cache": None,
                      "bfloat16": SERVE_BF16_RTOL},
           "failures": bad}
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 1 if bad else 0


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


def _mode(args) -> str:
    return "serve" if args.serve else "seq_inner" if args.seq_inner \
        else "train"


def _predict(args) -> dict:
    """``--predict``: the dry run of this mode's step at each rank of each
    of ``MESHES`` (and each of ``LAYOUTS`` under ``--seq-inner``), by the
    mesh names the measurement uses; each a list of the ranks'
    ``dryrun.summary``."""
    from repro_torch.launch.dryrun import dry_run

    mode = _mode(args)
    if mode == "train":
        cfg, shape = _setup(args)[:2]
        cells = {"x".join(map(str, m)): (m, None) for m in MESHES}
    elif mode == "serve":
        cfg, shape = _serve_cfg(args, "bfloat16")
        cells = {"x".join(map(str, m)): (m, None) for m in MESHES}
    else:
        cfg, shape = _prefill_setup(args)[:2]
        cells = {"x".join(map(str, m)) + "/" + layout: (m, over)
                 for m in MESHES for layout, over in LAYOUTS.items()}
    return {name: [dry_run(cfg, shape, m, rank=r, overrides=over)
                   for r in range(RANKS)]
            for name, (m, over) in cells.items()}


def _start_prediction(args):
    """The ``--predict`` child, on the host (no card), started now."""
    flags = {"serve": ["--serve"], "seq_inner": ["--seq-inner"],
             "train": []}[_mode(args)]
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *flags, "--predict",
         "--layers", str(args.layers), "--device", args.device],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def _against(child, meshes: dict, run: str = None) -> list:
    """Each mesh's ranks' measurements beside the dry run's prediction
    (into ``meshes[name]["dryrun"]``): the issued collectives must be
    equal; the peak's ratio is reported. ``run``: the serve run whose
    readings are compared. Returns what fails."""
    out, err = child.communicate(timeout=PREDICT_TIMEOUT_S)
    if child.returncode:
        return [f"the dry run's child failed: {err[-3000:]}"]
    predicted = json.loads(out.strip().splitlines()[-1])
    bad = []
    for name, entry in meshes.items():
        rows = []
        for r, (pred, meas) in enumerate(zip(predicted[name],
                                             entry["ranks"])):
            meas = meas[run] if run else meas
            same = pred["collectives"]["issued"] == meas["issued"]
            if not same:
                bad.append(f"{name} rank {r}: the dry run issues "
                           f"{pred['collectives']['issued']}, the cards "
                           f"{meas['issued']}")
            peak = meas.get("peak_gb")
            rows.append({
                "issued_equal": same,
                "collectives": pred["collectives"]["count"],
                "wire_gb": pred["collectives"]["wire_bytes"] / 1e9,
                "predicted_peak_gb": pred["memory"]["peak"] / 1e9,
                "measured_peak_gb": peak,
                "peak_ratio": (pred["memory"]["peak"] / 1e9 / peak
                               if peak else None),
                "predicted_flops": pred["flops"],
                "trace_s": pred["trace_s"]})
        entry["dryrun"] = rows
    return bad


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--layers", type=int, default=4)
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--serve", action="store_true",
                        help="the serve step in place of train and prefill")
    parser.add_argument("--seq-inner", action="store_true",
                        help="the prefill step alone, under seq_inner and "
                             "under rules_for's layout")
    parser.add_argument("--dryrun", action="store_true",
                        help="the dry run's prediction beside each rank's "
                             "measurement")
    parser.add_argument("--predict", action="store_true",
                        help="(the child of --dryrun) print the dry run's "
                             "predictions and exit")
    parser.add_argument("--json", help="also write the result here")
    args = parser.parse_args()
    if args.predict:
        print(json.dumps(_predict(args)), flush=True)
        return 0
    cuda = args.device != "cpu"
    if cuda and torch.cuda.device_count() < RANKS:
        raise SystemExit(f"needs {RANKS} CUDA cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = (subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines() if cuda else ["cpu"])
    if args.serve:
        return serve_main(args, card)
    if args.seq_inner:
        return seq_inner_main(args, card)
    from repro_torch.launch.mesh import release_process_group

    child = _start_prediction(args) if args.dryrun else None
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
    if child is not None:
        bad += _against(child, meshes)
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
