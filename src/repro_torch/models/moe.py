"""Mixture-of-Experts: top-k router and capacity-based dispatch, as PyTorch
ops.

Counterpart of the JAX package's ``models/moe.py``. The reference has no
Pallas kernel here: routing, dispatch and the expert FFNs are jnp, so the
port keeps them as PyTorch ops, every product an einsum.

Dispatch is row-local (per batch row), as in the reference: each (token,
choice) pair of a row takes the next free slot of its expert, in (token,
choice) order, and a pair past the expert's capacity ``C`` is dropped. The
slots keep the reference's (B, E, C, D) layout, empty slots read the zero
pad row ``S``, and every dropped pair scatters into one trash slot ``E*C``
that is thrown away (several writes may hit it; any one may win, since all
write the pad index). The expert FFN runs over every slot, occupied or not,
as the reference's does.

Top-k ties: ``jax.lax.top_k`` breaks them toward the lower expert index,
and ``torch.topk`` promises no order, so ``route`` takes the first k of a
stable descending sort. The router's logits, softmax and aux loss are f32;
the routing weights, the slots and the SwiGLU are in x's dtype.

In a mesh step's model-parallel region the experts' leaves may hold only
this rank's ``expert_ffn`` columns (``w_up`` narrower than ``d_ff``): the
router, its aux loss and the dispatch are computed whole on every model
rank, the tokens ``enter`` the region before the dispatch, each rank runs
its columns of every expert's SwiGLU, and the combine weights its partial outputs by the
routing weights, which ``enter`` too, before ``leave`` sums them. So the
routing weights' gradient arrives whole on every rank, and the router's
gradient (its aux loss's part included) is the same on each: no sum.

Under a sequence split of the residual stream (``sharding.seq_parallel``,
Megatron-SP) the block's input is this rank's rows. Dispatch is
row-local over the whole sequence, so ``enter`` gathers it first and the
router reads the gathered tokens; the combine's partial outputs then
``leave`` by a reduce-scatter into this rank's rows (the reference's
``shard_act`` on the combine). Where the experts are split, every
gradient inside the region is partial, as that reduce-scatter's
backward sums it: the routing weights do not ``enter`` (their gradient
from each rank's columns is partial), and the aux loss, the same on
every rank, passes ``once``, so that only the first model rank's
gradient counts it. The router's gradient is then partial on each rank,
and summed over "model" (``transformer.model_roles``). With whole
experts the block gathers its input and takes its own rows of its
output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.parallel.sharding import (
    PDef, batch_shards, batch_sum, current_seq_split, enter, leave, once,
)


def moe_defs(cfg: ArchConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": PDef((d, e), ("fsdp", "act_experts"), dtype=torch.float32),
        "w_gate": PDef((e, d, f), ("experts", "fsdp", "expert_ffn")),
        "w_up": PDef((e, d, f), ("experts", "fsdp", "expert_ffn")),
        "w_down": PDef((e, f, d), ("experts", "expert_ffn", "fsdp")),
    }


def capacity(cfg: ArchConfig, tokens_per_row: int) -> int:
    c = int(cfg.experts_per_token * tokens_per_row * cfg.capacity_factor
            / cfg.num_experts)
    return max(c, cfg.experts_per_token)


def route(cfg: ArchConfig, p, x: torch.Tensor):
    """x: (B, S, D) -> (weights (B,S,k) in x's dtype, expert ids (B,S,k),
    aux loss (f32 scalar))."""
    logits = x.float() @ p["router"]  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    # stable: equal probabilities keep the lower expert first, as top_k does
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    weights, ids = weights[..., :k], ids[..., :k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance aux loss
    e = cfg.num_experts
    n = batch_shards()
    if n == 1:
        density = F.one_hot(ids[..., 0], e).float().mean(dim=(0, 1))
        density_proxy = probs.mean(dim=(0, 1))
    else:
        # a share of a data-parallel batch: the density over the whole
        # batch, and this share's part of the proxy's batch mean, so that
        # the shares' aux losses (and their gradients) sum to the batch's
        tokens = ids.shape[0] * ids.shape[1] * n
        density = batch_sum(
            F.one_hot(ids[..., 0], e).float().sum(dim=(0, 1))) / tokens
        density_proxy = probs.sum(dim=(0, 1)) / tokens
    aux = e * (density * density_proxy).sum()
    return weights.to(x.dtype), ids, aux


def dispatch_slots(ids: torch.Tensor, num_experts: int, cap: int):
    """ids (B, S, k) -> (dest (B, S*k), keep (B, S*k)): each (token, choice)
    pair's slot ``expert*cap + n`` in the flattened (E*C) slots, ``n`` its
    inclusive prefix count among the row's pairs for that expert less one;
    pairs with ``n >= cap`` are dropped (``keep`` False) to the trash slot
    ``E*cap``."""
    b = ids.shape[0]
    flat_ids = ids.reshape(b, -1)
    # prefix counts along the last axis of (B, E, S*k): on the card a scan
    # along the middle axis of (B, S*k, E) runs only B*E scans in parallel
    csum = F.one_hot(flat_ids, num_experts).transpose(1, 2).cumsum(dim=-1)
    slot = csum.gather(1, flat_ids[:, None, :])[:, 0] - 1
    keep = slot < cap
    dest = torch.where(keep, flat_ids * cap + slot, num_experts * cap)
    return dest, keep


def moe_apply(cfg: ArchConfig, p, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D) in x's dtype, aux loss)."""
    split = p["w_up"].shape[2] != cfg.d_ff
    if current_seq_split() is None:
        weights, ids, aux = route(cfg, p, x)
        if split:
            x, weights = enter(x), enter(weights)
    else:  # the router reads the gathered sequence
        x = enter(x, split)
        weights, ids, aux = route(cfg, p, x)
        if split:
            aux = once(aux)
    b, s, d = x.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    cap = capacity(cfg, s)

    # ---- row-local dispatch: the source token of each (E*C) slot ----------
    dest, keep = dispatch_slots(ids, e, cap)
    token_idx = torch.arange(s * k, device=x.device) // k
    src_for_slot = torch.full((b, e * cap + 1), s, dtype=torch.int64,
                              device=x.device)  # s = the zero pad row
    src_for_slot.scatter_(1, dest, torch.where(keep, token_idx, s))
    src_for_slot = src_for_slot[:, :-1]  # drop the trash slot
    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    dispatched = x_pad.gather(1, src_for_slot[..., None].expand(-1, -1, d))
    dispatched = dispatched.reshape(b, e, cap, d)

    # ---- expert FFN (SwiGLU) over every slot ------------------------------
    w_gate, w_up, w_down = (p[n].to(x.dtype)
                            for n in ("w_gate", "w_up", "w_down"))
    h = F.silu(torch.einsum("becd,edf->becf", dispatched, w_gate))
    h = h * torch.einsum("becd,edf->becf", dispatched, w_up)
    out_slots = torch.einsum("becf,efd->becd", h, w_down).reshape(
        b, e * cap, d)

    # ---- combine: each choice's slot output, weighted, summed per token ---
    slot_out = torch.cat([out_slots, out_slots.new_zeros((b, 1, d))], dim=1)
    per_choice = slot_out.gather(1, dest[..., None].expand(-1, -1, d))
    per_choice = per_choice * weights.reshape(b, s * k, 1).to(
        per_choice.dtype)
    out = per_choice.reshape(b, s, k, d).sum(dim=2)
    return leave(out, split), aux
