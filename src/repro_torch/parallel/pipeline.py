"""GPipe-style pipeline parallelism over one mesh axis (e.g. "pod").

Counterpart of the JAX package's ``parallel/pipeline.py``. Layers are split
into S contiguous stages, one a rank of the axis; microbatches stream
through a point-to-point ring, s -> s+1, stage 0 receiving zeros. At step
t stage s runs microbatch t (stage 0) or what the ring brought it (the
others); from step S-1 on the last stage's output is a finished
microbatch, and the outputs, zero on every other stage, are summed across
stages, so every rank returns the whole (M, mb, ...) output. The backward
is autograd through the ring (``_Ring``: its backward sends the gradient
the reverse way) and through the sum, whose backward passes the gradient
through unchanged: every rank holds the same output and the same loss, so
each stage's parameters get the gradient of that one loss, as ``jax.grad``
through the reference's ``shard_map`` gives them. The schedule is the
standard fill/drain one: bubble fraction (S-1)/(M+S-1).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch._tree import tree_map
from repro_torch.parallel.sharding import is_dtensor


def _exchange(send: torch.Tensor, recv: torch.Tensor, group,
              to: int, frm: int) -> None:
    """Send ``send`` to group rank ``to`` and receive ``recv`` from group
    rank ``frm`` (either may be None)."""
    ops = []
    if to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(),
                              dist.get_global_rank(group, to), group))
    if frm is not None:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, frm), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _Ring(torch.autograd.Function):
    """Stage s sends ``y`` to s+1 and returns what s-1 sent (zeros on
    stage 0); the backward sends the gradient back to s-1 and returns the
    one s+1 sent (zeros on the last stage)."""

    @staticmethod
    def forward(ctx, y, group, stage, stages):
        ctx.group, ctx.stage, ctx.stages = group, stage, stages
        out = torch.zeros_like(y)
        _exchange(y, out, group, stage + 1 if stage + 1 < stages else None,
                  stage - 1 if stage > 0 else None)
        return out

    @staticmethod
    def backward(ctx, grad):
        s, n = ctx.stage, ctx.stages
        dy = torch.zeros_like(grad)
        _exchange(grad, dy, ctx.group, s - 1 if s > 0 else None,
                  s + 1 if s + 1 < n else None)
        return dy, None, None, None


class _StageSum(torch.autograd.Function):
    """The sum over the stages; every rank then holds the same value and
    computes the same loss, so the gradient passes through as it is."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def pipeline_apply(
    mesh,
    axis: str,
    stage_fn: Callable,  # (stage_params, x) -> y, same shape
    stacked_params,      # leaves (num_stages, ...): DTensors sharded over
                         # `axis`, or whole tensors on every rank
    microbatches: torch.Tensor,  # (M, mb, ...), the same on every rank
) -> torch.Tensor:
    """Returns the (M, mb, ...) outputs after all S stages, on every rank."""
    k = mesh.mesh_dim_names.index(axis)
    stages, stage = mesh.size(k), mesh.get_local_rank(k)
    group = mesh.get_group(k)
    m_count = microbatches.shape[0]
    steps = m_count + stages - 1

    def mine(v):  # this stage's (1, ...) slice
        return v.to_local() if is_dtensor(v) else v[stage:stage + 1]

    params_local = tree_map(lambda v: mine(v)[0], stacked_params)
    first = torch.tensor(stage == 0, device=microbatches.device)
    last = torch.tensor(stage == stages - 1, device=microbatches.device)
    zero = torch.zeros_like(microbatches[0])
    state = zero
    outs = []
    for t in range(steps):
        inject = microbatches[t] if t < m_count else zero
        y = stage_fn(params_local, torch.where(first, inject, state))
        if t >= stages - 1:
            # finished microbatch leaves the last stage
            outs.append(torch.where(last, y, torch.zeros_like(y)))
        if t + 1 < steps:
            state = _Ring.apply(y, group, stage, stages)
    return _StageSum.apply(torch.stack(outs), group)


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
