"""End-to-end training driver of the port, on one card or on a mesh.

Counterpart of the JAX package's ``launch/train.py``. On its single-device
path (``mesh=None``): config-driven, the deterministic data pipeline with
prefetch, the reference's step (``forward_loss`` at ``cfg.remat``, the
backward, AdamW at lr 1e-3), async checkpointing with restart-resume in
the reference's format, straggler bookkeeping, and an optional GA offload
search before the run (the paper's Steps 1–3 ahead of Step 6). The step
runs through kernels B2, B3 and B4 with their gradients
(``kernels/*/ops.py``), and updates the train state in place where the
reference donates it.

    python -m repro_torch.launch.train --device cpu        # reduced, CPU
    python -m repro_torch.launch.train --full --seq-len 2048 --global-batch 2
    python -m repro_torch.launch.train --arch rwkv6-1.6b --full ...

Every family but the VLM trains here: dense, MoE, RWKV (B4's forward and
its backward kernel), the hybrid and the enc-dec family. The VLM is refused
as the reference's own ``train()`` fails on it (``NOT_TRAINABLE``); its
step trains through ``train_step`` on ``models.synthetic_batch``, as the
reference's tests train it.

``train(..., mesh=...)`` is the reference's mesh path: ``rules_for`` the
cell, ``build_train_step`` (with ``search_first``'s decisions, the
config's own ``accum``, AdamW at the reference's default lr 3e-4), the
state laid out by the rules on the mesh (``launch/mesh.py``
``make_mesh_compat``; one card is a 1×1 mesh) and the loop under
``use_mesh``. Checkpoints keep their format: each leaf is saved whole (rank
0 writes) and restored into each rank's shard. An Adafactor config is
refused there (``check_trainable``): the reference's ``train(mesh=...)``
hands ``init_train_state``'s AdamW state to an Adafactor step, which
fails; train Adafactor through ``build_train_step`` with
``init_factored_state``'s state.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.profiler import record_function

from repro_torch._device import resolve_device
from repro_torch._tree import leaves
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import SHAPES, get_config, reduced as reduce_cfg
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core import GAConfig, search_lm_cell
from repro_torch.data import DataConfig, SyntheticLMStream, device_put_batch
from repro_torch.launch.mesh import chips, mesh_device, mesh_shape_dict
from repro_torch.launch.steps import (
    build_train_step, init_train_state, place,
)
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.parallel.layouts import rules_for
from repro_torch.parallel.sharding import use_mesh
from repro_torch.runtime import StragglerDetector

# the families ``train()`` refuses, and why
NOT_TRAINABLE = {
    "vlm": "the reference's train() fails on a vision config: its data "
           "pipeline rolls the labels from the tokens, (B, S - P), while "
           "the logits cover the P patches too, (B, S), and "
           "cross_entropy_loss's einsum refuses the two lengths; train its "
           "step through train_step on models.synthetic_batch (labels over "
           "every position, the loss mask zero over the patches), as the "
           "reference's tests do",
}


def check_trainable(cfg: ArchConfig, mesh=None) -> None:
    """Raise NotImplementedError for what this driver does not train, and
    ValueError for a mesh that is not one over this process group."""
    if cfg.family in NOT_TRAINABLE:
        raise NotImplementedError(f"{cfg.name} cannot train here: "
                                  f"{NOT_TRAINABLE[cfg.family]}")
    if mesh is None:
        return
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not isinstance(mesh, DeviceMesh) or chips(mesh) != world:
        got = (mesh_shape_dict(mesh) if hasattr(mesh, "mesh_dim_names")
               or hasattr(mesh, "axis_names") else type(mesh).__name__)
        raise ValueError(
            f"train() takes a DeviceMesh over the whole process group "
            f"(world size {world}), got {got}: build it with "
            f"launch/mesh.py make_mesh_compat")
    if cfg.optimizer == "adafactor":
        raise NotImplementedError(
            f"{cfg.name} uses Adafactor, and the reference's "
            f"train(mesh=...) fails on it: it builds AdamW's state "
            f"(init_train_state) and hands it to an Adafactor step; train "
            f"it through build_train_step with init_factored_state's state")


def train_step(cfg: ArchConfig, model: T.TransformerLM, state: dict,
               grads: dict, batch: dict, opt_cfg: AdamWConfig,
               mark: Optional[Callable[[str], None]] = None) -> dict:
    """One step, in place: zero the stacked gradients, ``forward_loss`` at
    ``cfg.remat``, the backward (into ``grads``, which
    ``bind_stacked_grads`` bound to ``model``), AdamW on ``state``.
    Returns the reference's metrics as tensors: ``loss``, ``ce_loss``,
    ``moe_aux``, ``grad_norm`` and ``lr``. Its three parts are profiler
    spans ``forward``, ``backward`` and ``optimizer``; ``mark``, if given,
    is called with each part's name as it starts and with ``"end"``."""
    mark = mark or (lambda part: None)
    for g in leaves(grads):
        g.zero_()
    mark("forward")
    with record_function("forward"):
        loss, metrics = T.forward_loss(cfg, model, batch, remat=cfg.remat)
    mark("backward")
    with record_function("backward"):
        loss.backward()
    mark("optimizer")
    with record_function("optimizer"):
        _, _, om = adamw_update(state["params"], grads, state["opt"],
                                opt_cfg)
    state["step"] = state["step"] + 1
    mark("end")
    return dict(metrics, loss=loss.detach(), **om)


def train(
    arch: Union[str, ArchConfig] = "llama3.2-3b",
    *,
    use_reduced: bool = True,
    steps: int = 100,
    global_batch: int = 8,
    seq_len: int = 64,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 50,
    resume: bool = True,
    search_first: bool = False,
    log_every: int = 10,
    mesh=None,
    device=None,
) -> dict:
    """Train ``arch`` (a name of ``configs/archs.py``, or a config, which
    is then used as given) for ``steps`` steps on ``device`` (None: the
    card), or on ``mesh`` (a ``DeviceMesh``, on its device); returns
    ``final_loss``, ``initial_loss``, ``losses``, ``steps`` (run here,
    after a resume) and ``wall_s``."""
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    if use_reduced:
        cfg = reduce_cfg(cfg)
    check_trainable(cfg, mesh)
    device = resolve_device(device) if mesh is None else mesh_device(mesh)
    shape = ShapeSpec("train_cli", "train", seq_len, global_batch)

    dec = None
    if search_first:
        mesh_shape = {"data": 16, "model": 16}
        res = search_lm_cell(cfg, SHAPES["train_4k"], mesh_shape,
                             GAConfig(population=8, generations=8))
        dec = res.best_decisions
        print(f"[search] best decisions: {dec}")

    rules = None
    state = init_train_state(cfg, device=device)
    if mesh is None:
        opt_cfg = AdamWConfig(lr=1e-3)
    else:
        rules = rules_for(cfg, shape, mesh)
        prog = build_train_step(cfg, shape, mesh, rules, dec)
        mesh_step = prog.jitted()
        state = place(state, prog.in_shardings[0])

    ck = Checkpointer(checkpoint_dir) if checkpoint_dir else None
    start_step = 0
    if ck and resume and ck.latest_step() is not None:
        start_step = ck.latest_step()
        state = ck.restore(start_step, state)
        print(f"[resume] restored step {start_step}")
    if mesh is None:
        model = T.TransformerLM.from_stacked(cfg, state["params"])
        grads = T.bind_stacked_grads(model, state["params"])

    stream = SyntheticLMStream(cfg, shape, DataConfig(seed=0))
    it = stream.prefetching(start_step=start_step)
    det = StragglerDetector()
    losses = []
    t_start = time.time()
    try:
        for i in range(start_step, steps):
            step_id, batch = next(it)
            batch = device_put_batch(batch, device)
            t0 = time.time()
            if mesh is None:
                metrics = train_step(cfg, model, state, grads, batch, opt_cfg)
            else:
                with use_mesh(mesh, rules):
                    state, metrics = mesh_step(state, batch)
            loss = float(metrics["loss"])
            det.record(0, time.time() - t0)
            losses.append(loss)
            if log_every and (i % log_every == 0 or i == steps - 1):
                print(f"step {i:5d} loss {loss:.4f} "
                      f"({(time.time() - t0) * 1e3:.0f} ms)")
            if ck and checkpoint_every and (i + 1) % checkpoint_every == 0:
                ck.save(i + 1, state)
        if ck:
            ck.save(steps, state, blocking=True)
    finally:
        it.close()

    return {"final_loss": losses[-1] if losses else float("nan"),
            "initial_loss": losses[0] if losses else float("nan"),
            "losses": losses, "steps": len(losses),
            "wall_s": time.time() - t_start}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="use the full (non-reduced) config")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--search-first", action="store_true",
                    help="run the GA offload search before training")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    out = train(args.arch, use_reduced=not args.full, steps=args.steps,
                global_batch=args.global_batch, seq_len=args.seq_len,
                checkpoint_dir=args.checkpoint_dir,
                search_first=args.search_first, device=args.device)
    print(f"done: loss {out['initial_loss']:.4f} -> {out['final_loss']:.4f} "
          f"in {out['wall_s']:.1f}s")


if __name__ == "__main__":
    main()
