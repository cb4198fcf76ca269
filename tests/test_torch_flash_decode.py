"""Flash-decode in one process: the serve step's sequence split of the KV
cache (``models/attention.py`` ``decode_attention`` under
``parallel/sharding.py`` ``kv_split``) against the whole cache.

A seeded cache (numpy, seed 0) is cut into n ∈ {1, 2, 4} shards along its
sequence. Each shard runs ``decode_attention`` as a rank would, on a
thread of its own under a ``KvSplit`` whose all-reduce is a stacked
reduction over the n threads (``Stacked``: each thread hands its tensor
in and every thread reads their max or sum), so that the port's own code
writes, masks and combines. Three steps from per-slot positions that
straddle the shard boundaries (a slot whose rows all lie on the first
shard, so the others are empty for it; a slot that writes across a
boundary), on the causal cache, the sliding window's ring (a slot that
wraps, one past the wrap) and an unmasked memory (cross-attention), in f32
and in bf16, the cache's own dtype. Held: each step's output within 1e-6
of its max of ``decode_attention`` on the whole cache (``_grouped_sdpa``),
and the shards, joined, equal to the whole cache after its writes. Then
the serve step's layout refusals (``launch/steps.py`` ``serve_layout``).
"""
import dataclasses
import functools
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.launch.steps import serve_layout
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.parallel.layouts import rules_for
from repro_torch.parallel.sharding import KvSplit, kv_split

B, STEPS = 4, 3
# (window, cache rows, per-slot positions at the first step)
MASKS = {"causal": (0, 64, [0, 30, 32, 60]),
         "ring": (32, 32, [5, 14, 31, 40]),
         "memory": (0, 64, [3, 3, 3, 3])}


class Stacked:
    """The all-reduce of ``n`` ranks that are threads of one process: each
    hands in its tensor, and every one reads the stacked max or sum."""

    def __init__(self, n: int):
        self.parts = [None] * n
        self.barrier = threading.Barrier(n)

    def reduce(self, rank: int, x: torch.Tensor, op: str) -> torch.Tensor:
        self.parts[rank] = x
        self.barrier.wait()
        stacked = torch.stack(self.parts)
        out = stacked.amax(0) if op == "max" else stacked.sum(0)
        self.barrier.wait()
        return out


def _on_threads(n: int, fn) -> list:
    """``fn(rank)`` on ``n`` threads at once; their results in rank order."""
    out, failed = [None] * n, []

    def run(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # re-raised on the caller's thread
            failed.append(e)
    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failed:
        raise failed[0]
    return out


def _setup(dtype, rows):
    """GQA 2 (4 heads over 2 KV heads of 16) on reduced llama3.2-3b in f32:
    a layer's attention weights, the inputs of each step and a cache of
    seeded rows in ``dtype``."""
    cfg = dataclasses.replace(reduced(get_config("llama3.2-3b")),
                              dtype="float32", num_kv_heads=2)
    params = T.init_param_tree(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    p = {k: v[0] for k, v in params["layers"]["attn"].items()}
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal(
        (STEPS, B, 1, cfg.d_model)).astype(np.float32))
    shape = (B, rows, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = {k: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype) for k in ("k", "v")}
    return cfg, p, xs, cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("n", [1, 2, 4])
def test_split_cache_combines_to_the_whole(n, mask, dtype):
    window, rows, positions = MASKS[mask]
    cfg, p, xs, cache = _setup(getattr(torch, dtype), rows)
    whole = {k: v.clone() for k, v in cache.items()}
    part = rows // n
    shards = [{k: v[:, r * part:(r + 1) * part].clone()
               for k, v in cache.items()} for r in range(n)]
    memory = mask == "memory"
    for t in range(STEPS):
        pos = torch.tensor(positions, dtype=torch.int32) + t
        x = xs[t]
        kw = dict(window=window)
        if memory:
            want, _ = A.decode_attention(cfg, p, x, {}, pos, rope=False,
                                         kv_memory=(whole["k"], whole["v"]))
        else:
            want, _ = A.decode_attention(cfg, p, x, whole, pos, **kw)
        group = Stacked(n)

        def rank(r):
            split = KvSplit(r, n, functools.partial(group.reduce, r))
            with kv_split(split):
                if memory:
                    return A.decode_attention(
                        cfg, p, x, {}, pos, rope=False,
                        kv_memory=(shards[r]["k"], shards[r]["v"]))[0]
                return A.decode_attention(cfg, p, x, shards[r], pos, **kw)[0]

        outs = _on_threads(n, rank)
        scale = float(want.abs().max())
        for r, got in enumerate(outs):
            err = float((got - want).abs().max())
            assert err <= 1e-6 * scale, (n, mask, dtype, t, r, err, scale)
        for k in ("k", "v"):
            joined = torch.cat([s[k] for s in shards], dim=1)
            assert torch.equal(joined, whole[k]), (n, mask, dtype, t, k)


def test_an_empty_shard_gives_no_nan_and_no_weight():
    """A slot at position 0 on four shards of 16: shards 1-3 hold no live
    row of it, every score there NEG_INF, which the global max sends to
    exp(...) = 0; the output is finite and the first shard's alone."""
    cfg, p, xs, cache = _setup(torch.float32, 64)
    pos = torch.zeros((B,), dtype=torch.int32)
    group = Stacked(4)
    shards = [{k: v[:, r * 16:(r + 1) * 16].clone() for k, v in cache.items()}
              for r in range(4)]

    def rank(r):
        with kv_split(KvSplit(r, 4, functools.partial(group.reduce, r))):
            return A.decode_attention(cfg, p, xs[0], shards[r], pos)[0]

    outs = _on_threads(4, rank)
    alone, _ = A.decode_attention(cfg, p, xs[0], {k: v[:, :16].clone()
                                                  for k, v in cache.items()},
                                  pos)
    for got in outs:
        assert torch.isfinite(got).all()
        assert float((got - alone).abs().max()) <= 1e-6 * float(
            alone.abs().max())


def _stand_in(axes, shape):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


@pytest.mark.parametrize("override, match", [
    ({"act_heads": "model"}, "keeps its heads' chunk"),
    ({"kv_batch": None}, "its batch is split over"),
    ({"kv_seq": None, "act_kv_heads": "model"}, "split along its sequence"),
])
def test_a_layout_the_serve_step_cannot_split_raises(override, match):
    """No fallback: where the rules lay the decode state out otherwise than
    the serve step splits it (attention's heads over "model", a cache's
    batch whole where the tokens' is split, a cache split by heads too),
    the layout raises, naming the leaf, its shape, its spec and the
    mesh."""
    mesh = _stand_in(("data", "model"), (2, 2))
    cfg = reduced(get_config("llama3.2-3b"))
    shape = ShapeSpec("d", "decode", 64, 4)
    rules = rules_for(cfg, shape, mesh, overrides=override)
    with pytest.raises(ValueError, match=match):
        serve_layout(cfg, shape, rules, mesh)
