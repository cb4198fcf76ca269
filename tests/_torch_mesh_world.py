"""The port's mesh programs on a sharded world: 4 gloo ranks on the CPU.

    python tests/_torch_mesh_world.py REF.npz OUT.json

``tests/test_torch_mesh_train.py`` runs this script in a subprocess (with
a timeout of its own) after computing the JAX package's 1×1 results into
REF.npz. Each of 4 processes (``torch.multiprocessing``, a gloo group over
a file store) builds a (2, 2) ("data", "model") mesh and runs the five
cells of the reference's ``tests/test_dryrun_small.py`` as programs, and
three more train cells: mixtral-8x7b (the MoE's load-balance loss over a
split batch), llama3.2-3b with Adafactor (its row, column and RMS means
over sharded leaves) and llama3.2-3b with int8 gradient compression (its
scale, a max over every shard); on the reduced configs in f32 with
``accum`` 2 where a cell trains: the loss, AdamW's grad norm (a sum over
every shard) and the whole updated train state, the prefill logits, the
logits of three decode steps and the decode state, each held to the
reference's (``mismatches``). Then ``pipeline_apply`` over a 4-rank "stage" mesh:
forward within 1e-5 and gradient within 1e-4 of the sequential ones. Any
rank's failure raises, and the script exits non-zero; rank 0 writes a
summary to OUT.json. JAX-free: it imports only the port.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import re
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CELLS = [
    ("llama3.2-3b", ("t", "train", 32, 8), ""),
    ("mixtral-8x7b", ("p", "prefill", 64, 4), ""),
    ("rwkv6-1.6b", ("d", "decode", 64, 4), ""),
    ("zamba2-7b", ("d", "decode", 64, 4), ""),
    ("seamless-m4t-medium", ("t", "train", 32, 8), ""),
    # beyond the reference's five: the MoE's load-balance loss under a
    # data-parallel split (its batch means taken over both shares), and
    # the optimizers' reductions over sharded leaves
    ("mixtral-8x7b", ("t", "train", 32, 8), ""),
    ("llama3.2-3b", ("t", "train", 32, 8), "adafactor"),
    ("llama3.2-3b", ("t", "train", 32, 8), "compress"),
]
# a variant's config overrides and compress_grads
VARIANTS = {"": ({}, False), "adafactor": ({"optimizer": "adafactor"}, False),
            "compress": ({}, True)}
# the share of a train state leaf's elements allowed beyond 1e-5 of its
# scale (``mismatches``)
TRAIN_OUTLIERS = 1e-3
RANKS = 4


def cell_key(arch: str, cell: tuple, variant: str) -> str:
    """The cell's name, and the prefix of its leaves in REF.npz."""
    return f"{arch}/{cell[1]}" + (f"/{variant}" if variant else "")


# ---------------------------------------------------------------------------
# Comparison (shared with tests/test_torch_mesh_train.py)
# ---------------------------------------------------------------------------


def flat(tree, prefix: str = "") -> dict:
    """``{"['a']['b']": leaf}`` over nested dicts and lists, the paths as
    ``jax.tree_util.keystr`` writes them."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype == np.uint16 or a.dtype.name == "bfloat16"


def as_f32(a) -> np.ndarray:
    a = np.asarray(a)
    if _is_bf16(a):
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def mismatches(port: dict, ref: dict, what: str,
               outliers: float = 0.0) -> list[str]:
    """The leaves of ``port`` (flat, numpy) that are not close to ``ref``'s.
    A leaf of scale S (its max |reference value|; for the error feedback
    ``ef``, 254 times that, the span of the int8 grid whose rounding error
    it holds) must have every element within 1e-5 of S, a bf16 leaf's
    also within one bf16 ulp of their own. Integers must be equal. A train
    state's comparison passes ``outliers`` (``TRAIN_OUTLIERS``): then a
    share that large of a leaf's elements (one at least) may lie within
    only 1e-2 of S. That is where the optimizers' arithmetic amplifies f32
    rounding: AdamW's and Adafactor's normalized steps turn a gradient
    element at the noise floor into an update of lr's size, and an int8
    rounding flip moves ``ef`` by one grid step."""
    bad = []
    if sorted(port) != sorted(ref):
        return [f"{what}: leaves {sorted(port)} != {sorted(ref)}"]
    for path in sorted(ref):
        name = f"{what}{path}"
        p, r = np.asarray(port[path]), np.asarray(ref[path])
        if np.issubdtype(r.dtype, np.integer) and not _is_bf16(r):
            if not np.array_equal(p, r):
                bad.append(f"{name}: integers differ")
            continue
        pf, rf = as_f32(p), as_f32(r)
        if pf.shape != rf.shape:
            bad.append(f"{name}: shape {pf.shape} != {rf.shape}")
            continue
        scale = float(np.max(np.abs(rf), initial=0.0)) or 1e-30
        if "['ef']" in name:
            scale *= 254
        err = np.abs(pf - rf)
        tol = np.full(rf.shape, 1e-5 * scale, np.float32)
        if _is_bf16(r):
            tol = np.maximum(tol, np.abs(rf) * 2.0 ** -7)
        over = int((err > tol).sum())
        if over > (max(1, int(outliers * err.size)) if outliers else 0):
            bad.append(f"{name}: {over} of {err.size} elements beyond "
                       f"1e-5 of {scale:.3g}")
        if float(err.max(initial=0.0)) > 1e-2 * scale:
            bad.append(f"{name}: error {float(err.max()):.3g} beyond 1e-2 "
                       f"of {scale:.3g}")
    return bad


# ---------------------------------------------------------------------------
# One rank
# ---------------------------------------------------------------------------


def _tree(ref, prefix: str) -> dict:
    """The nested dict of REF.npz's leaves under ``prefix``."""
    out: dict = {}
    for key in ref.files:
        if not key.startswith(prefix):
            continue
        names = re.findall(r"\['([^']*)'\]", key[len(prefix):])
        node = out
        for n in names[:-1]:
            node = node.setdefault(n, {})
        node[names[-1]] = ref[key]
    return out


def _torch(tree):
    """Numpy leaves as CPU tensors, uint16 leaves as the bf16 they hold."""
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    a = np.array(tree)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _check(bad: list[str]) -> None:
    if bad:
        raise AssertionError(f"rank {dist.get_rank()}: " + "; ".join(bad[:8]))


def _cell(arch: str, cell: tuple, variant: str, ref, mesh) -> None:
    from repro_torch.configs import ShapeSpec, get_config, reduced
    from repro_torch.launch.steps import build_cell_program, build_train_step
    from repro_torch.models.transformer import init_decode_state
    from repro_torch.models.weights import (
        state_to_numpy, train_state_from_reference)
    from repro_torch.parallel.layouts import rules_for
    from repro_torch.parallel.sharding import full, use_mesh

    shape = ShapeSpec(*cell)
    overrides, compress = VARIANTS[variant]
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                              accum=2 if shape.kind == "train" else 1,
                              **overrides)
    rules = rules_for(cfg, shape, mesh)
    prog = (build_train_step(cfg, shape, mesh, rules, compress_grads=compress)
            if shape.kind == "train"
            else build_cell_program(cfg, shape, mesh, rules))
    step = prog.jitted()
    key = cell_key(arch, cell, variant) + "/"
    what = key[:-1] + " "
    if shape.kind == "train":
        state = train_state_from_reference(
            cfg, _torch(_tree(ref, key + "in_state")), "cpu",
            shardings=prog.in_shardings[0])
        with use_mesh(mesh, rules):
            state, m = step(state, _torch(_tree(ref, key + "batch")))
        rmetrics = _tree(ref, key + "metrics")
        if sorted(m) != sorted(rmetrics):
            _check([f"{what}metrics {sorted(m)} != {sorted(rmetrics)}"])
        for k in ("loss", "grad_norm"):
            if k in rmetrics:
                got, want = float(m[k]), float(rmetrics[k])
                if abs(got - want) > 1e-5 * abs(want):
                    _check([f"{what}{k} {got} != {want}"])
        _check(mismatches(flat(state_to_numpy(state)),
                          flat(_tree(ref, key + "out_state")), what,
                          outliers=TRAIN_OUTLIERS))
        return
    params = _tree(ref, key + "params")
    if shape.kind == "prefill":
        with use_mesh(mesh, rules):
            logits = step(params, _torch(_tree(ref, key + "batch")))
        _check(mismatches({"": full(logits).numpy()},
                          {"": ref[key + "logits"]}, what + "logits"))
        return
    # the port's own fresh state: the reference's values (zeros), with the
    # hybrid's conv in the model's dtype where the reference starts it in
    # bf16 (ROADMAP.md, a named divergence)
    state = init_decode_state(cfg, shape.global_batch, shape.seq_len,
                              device="cpu")
    _check(mismatches(flat(state_to_numpy(state)),
                      flat(_tree(ref, key + "in_state")), what + "init"))
    for t in range(3):
        tokens = (np.arange(shape.global_batch, dtype=np.int32) * 37
                  + 11 * t)
        with use_mesh(mesh, rules):
            logits, state = step(params, state, torch.from_numpy(tokens))
        _check(mismatches({"": full(logits).numpy()},
                          {"": ref[f"{key}logits{t}"]}, f"{what}logits{t}"))
    _check(mismatches(flat(state_to_numpy(state)),
                      flat(_tree(ref, key + "out_state")), what + "state"))


def _pipeline(ref) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel.pipeline import pipeline_apply

    mesh = init_device_mesh("cpu", (RANKS,), mesh_dim_names=("stage",))
    w = torch.from_numpy(np.array(ref["pipeline/w"])).requires_grad_(True)
    xs = torch.from_numpy(np.array(ref["pipeline/xs"]))
    out = pipeline_apply(mesh, "stage", lambda wi, x: torch.tanh(x @ wi),
                         w, xs)
    torch.sum(torch.square(out)).backward()
    grad = w.grad.clone()  # this stage's slice; the others' are zero
    dist.all_reduce(grad)
    return {"fwd_err": float(np.max(np.abs(
                out.detach().numpy() - ref["pipeline/out"]))),
            "bwd_err": float(np.max(np.abs(
                grad.numpy() - ref["pipeline/grad"])))}


def _rank(rank: int, store_path: str, ref_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, RANKS), rank=rank,
        world_size=RANKS, timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.launch.mesh import make_mesh_compat
        from repro_torch.launch.steps import build_train_step
        from repro_torch.configs import ShapeSpec, get_config, reduced
        from repro_torch.parallel.layouts import rules_for

        mesh = make_mesh_compat((2, 2), ("data", "model"), device="cpu")
        ref = np.load(ref_path)
        for arch, cell, variant in CELLS:
            _cell(arch, cell, variant, ref, mesh)
        pipe = _pipeline(ref)
        # a parameter's shard on this rank: the state really is sharded
        cfg = reduced(get_config("llama3.2-3b"))
        shape = ShapeSpec(*CELLS[0][1])
        sh = build_train_step(cfg, shape, mesh, rules_for(cfg, shape, mesh)
                              ).in_shardings[0]["params"]["layers"]["attn"]
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump({"cells": [cell_key(*c) for c in CELLS],
                           "pipeline": pipe,
                           "world": {"ranks": dist.get_world_size(),
                                     "mesh": dict(zip(mesh.mesh_dim_names,
                                                      mesh.shape))},
                           "wq_spec": list(sh["wq"].spec)}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(ref_path: str, out_path: str) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(os.path.join(tmp, "store"), ref_path,
                              out_path), nprocs=RANKS, join=True)


if __name__ == "__main__":
    main(*sys.argv[1:3])
