"""Adafactor-style optimizer: factored second moment + bf16 first moment.

Counterpart of the JAX package's ``optim/adafactor.py`` (Shazeer & Stern,
2018): v is stored as row/col means for matrices, full for vectors; the
update is RMS-clipped; the first moment (momentum) is kept in bf16; the
update math is f32. State cost ≈ 2 (m, bf16) + ~0 (factored v) = 4 B a
parameter with bf16 params, against AdamW's 10.

Like ``adamw_update``, ``adafactor_update`` writes the parameters and the
state in place, one leaf after another (``_sequenced_updates``, a plain
loop here: leaves are updated in order, so one leaf's f32 temporaries are
alive at a time, which is what the reference's optimization barriers
enforce). On a mesh the leaves are DTensors: each rank updates its shards,
and the row and column means and the RMS clip are taken over the whole
leaf (``parallel/sharding.py`` ``mean_over``), as GSPMD takes them in the
reference; ``vr`` and ``vc`` then hold the layout of the parameter's spec
without its last, or its second-to-last, dim.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch._tree import leaves, tree_map
from repro_torch.parallel.sharding import assign, local, mean_over


@dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 3e-4
    b1: float = 0.9
    decay: float = 0.99  # second-moment decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0


def init_factored_state(params: Any) -> dict:
    def zeros(shape, like):
        return torch.zeros(shape, dtype=torch.float32, device=like.device)

    def vr(p):
        return zeros(p.shape[:-1] if p.dim() >= 2 else p.shape, p)

    def vc(p):
        if p.dim() >= 2:
            return zeros(p.shape[:-2] + p.shape[-1:], p)
        return zeros((0,), p)

    first = leaves(params)[0]
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                            device=p.device), params),
        "vr": tree_map(vr, params),
        "vc": tree_map(vc, params),
        "count": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def _sequenced_updates(upd, items: list[tuple]) -> list:
    """Run the per-leaf updates one after another."""
    return [upd(*item) for item in items]


@torch.no_grad()
def adafactor_update(params: Any, grads: Any, state: dict,
                     cfg: AdafactorConfig, lr_scale=1.0):
    """Returns (params, state, metrics): the trees passed in, updated in
    place; metrics ``lr``."""
    count = local(state["count"]) + 1
    lr = cfg.lr * lr_scale

    def upd(p_, g_, m_, vr_, vc_):
        p, m, vr, vc = local(p_), local(m_), local(vr_), local(vc_)
        g = local(g_).float()
        g2 = torch.square(g) + cfg.eps
        if p.dim() >= 2:
            vr.mul_(cfg.decay).add_((1 - cfg.decay) * mean_over(g2, p_, -1))
            vc.mul_(cfg.decay).add_((1 - cfg.decay) * mean_over(g2, p_, -2))
            denom = torch.clamp(mean_over(vr, vr_, -1, keepdim=True),
                                min=cfg.eps)
            vhat = (vr[..., None] * vc[..., None, :]) / denom[..., None]
        else:
            vr.mul_(cfg.decay).add_((1 - cfg.decay) * g2)
            vhat = vr
        u = g * torch.rsqrt(vhat + cfg.eps)
        # RMS clip
        rms = torch.sqrt(mean_over(torch.square(u), p_) + cfg.eps)
        u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
        m2 = cfg.b1 * m.float() + (1 - cfg.b1) * u
        step = m2
        if cfg.weight_decay and p.dim() >= 2:
            step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
        m.copy_(m2)

    _sequenced_updates(upd, list(zip(
        leaves(params), leaves(grads), leaves(state["m"]),
        leaves(state["vr"]), leaves(state["vc"]))))
    assign(state, "count", count)
    return params, state, {"lr": lr}
