"""Mixed-precision AdamW (master-less): bf16 params, f32 moments.

Counterpart of the JAX package's ``optim/adamw.py``: the same
``AdamWConfig``, the same update in f32 cast on write, decoupled weight
decay on leaves of two or more dimensions, the same metrics. Memory: 2 + 4
+ 4 = 10 B a parameter. Where the reference donates its state to a jitted
step, this one updates it **in place**: ``adamw_update`` writes each
parameter leaf and its ``m`` and ``v`` one leaf after another, and a leaf
in slices of at most ``SLICE_ELEMENTS`` along its first axis, so that the
f32 temporaries of one slice only are alive at a time (the update is
elementwise, so the slices change no value; whether a leaf decays is
decided by the whole leaf's rank). The reference's barrier-sequenced
updates bound its temporaries in the same way.

``params`` and ``grads`` are trees of tensors of one structure
(``repro_torch/_tree.py``), ``grads`` in the params' dtype or f32. On a
mesh the leaves are DTensors of one layout a leaf: the update runs on each
rank's shards, and the global norm sums over every shard
(``parallel/sharding.py`` ``reduce_over``), as GSPMD sums in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch._tree import leaves, tree_map
from repro_torch.parallel.sharding import assign, local, reduce_over

# elements of one slice of a leaf that one update step takes: 64M, so that
# a step's f32 temporaries stay within a few hundred MB
SLICE_ELEMENTS = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params: Any) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    first = leaves(params)[0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree: Any) -> torch.Tensor:
    """The norm of every leaf together; a DTensor leaf's sum of squares is
    taken over its shards on every rank that holds one."""
    sums = [reduce_over(torch.sum(torch.square(local(x).float())), x)
            for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _slices(*leaves_: torch.Tensor):
    """Aligned slices of leaves of one shape along their first axis, each
    of at most ``SLICE_ELEMENTS`` elements (a whole leaf where one row is
    larger, or the leaf has no axis)."""
    first = leaves_[0]
    if first.dim() == 0 or first.numel() <= SLICE_ELEMENTS:
        yield leaves_
        return
    step = max(1, SLICE_ELEMENTS // max(first[0].numel(), 1))
    for i in range(0, first.shape[0], step):
        yield tuple(t[i:i + step] for t in leaves_)


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                 lr_scale=1.0):
    """Returns (params, state, metrics): ``params`` and ``state`` the trees
    passed in, updated in place; metrics ``grad_norm`` and ``lr``."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    count = local(state["count"]) + 1
    c1 = 1.0 - torch.pow(cfg.b1, count.float())
    c2 = 1.0 - torch.pow(cfg.b2, count.float())
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v, decay):
        g = g.float() * clip
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if decay:  # decoupled weight decay on matrices only
            step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)

    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        decay = p.dim() >= 2
        for part in _slices(*map(local, (p, g, m, v))):
            upd(*part, decay)
    assign(state, "count", count)
    return params, state, {"grad_norm": gnorm, "lr": lr}
