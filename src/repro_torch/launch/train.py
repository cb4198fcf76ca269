"""End-to-end training driver of the port, on one card.

Counterpart of the JAX package's ``launch/train.py`` on its single-device
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
reference's tests train it. Training on a mesh of several cards is not
ported yet (ROADMAP.md, slice 7c), and ``mesh`` other than None is refused.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Union

import torch
from torch.profiler import record_function

from repro_torch._device import resolve_device
from repro_torch._tree import leaves
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import SHAPES, get_config, reduced as reduce_cfg
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core import GAConfig, search_lm_cell
from repro_torch.data import DataConfig, SyntheticLMStream, device_put_batch
from repro_torch.launch.steps import init_train_state
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_update
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
    """Raise NotImplementedError for what this driver does not train."""
    if mesh is not None:
        raise NotImplementedError(
            "training on a mesh is not ported yet (ROADMAP.md, slice 7c: "
            "build_train_step, rules_for and the sharded layouts); pass "
            "mesh=None for one card")
    if cfg.family in NOT_TRAINABLE:
        raise NotImplementedError(f"{cfg.name} cannot train here: "
                                  f"{NOT_TRAINABLE[cfg.family]}")


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
    card); returns ``final_loss``, ``initial_loss``, ``losses``, ``steps``
    (run here, after a resume) and ``wall_s``."""
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    if use_reduced:
        cfg = reduce_cfg(cfg)
    check_trainable(cfg, mesh)
    device = resolve_device(device)
    shape = ShapeSpec("train_cli", "train", seq_len, global_batch)

    if search_first:
        mesh_shape = {"data": 16, "model": 16}
        res = search_lm_cell(cfg, SHAPES["train_4k"], mesh_shape,
                             GAConfig(population=8, generations=8))
        print(f"[search] best decisions: {res.best_decisions}")

    opt_cfg = AdamWConfig(lr=1e-3)
    state = init_train_state(cfg, device=device)

    ck = Checkpointer(checkpoint_dir) if checkpoint_dir else None
    start_step = 0
    if ck and resume and ck.latest_step() is not None:
        start_step = ck.latest_step()
        state = ck.restore(start_step, state)
        print(f"[resume] restored step {start_step}")
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
            metrics = train_step(cfg, model, state, grads, batch, opt_cfg)
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
