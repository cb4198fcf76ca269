"""The port's mesh programs on a sharded world: 4 gloo ranks on the CPU.

    python tests/_torch_mesh_world.py REF.npz OUT.json

``tests/test_torch_mesh_train.py`` runs this script in a subprocess (with
a timeout of its own) after computing the JAX package's 1×1 results into
REF.npz. Each of 4 processes (``torch.multiprocessing``, a gloo group over
a file store) builds a (2, 2) ("data", "model") mesh and runs the five
cells of the reference's ``tests/test_dryrun_small.py`` as programs, and
five more train cells: mixtral-8x7b (the MoE's load-balance loss over a
split batch), llama3.2-3b with Adafactor (its row, column and RMS means
over sharded leaves), llama3.2-3b with int8 gradient compression (its
scale, a max over every shard), and llama3.2-3b at remat "none" and
"dots"; on the reduced configs in f32 with ``accum`` 2 where a cell
trains: the loss, AdamW's grad norm (a sum over every shard) and the
whole updated train state, the prefill logits, the logits and greedy
tokens of three decode steps and the decode state, each held to the
reference's (``mismatches``). Every train and prefill cell splits its
residual stream along the sequence over "model" (Megatron-SP): among
them a llama3.2-3b train cell whose 3 heads do not divide the model
size (its attention gathers its input and takes its own rows) and a
llava-next-mistral-7b prefill whose patches and tokens split as one
sequence; two llama3.2-3b prefills keep the sequence on "model" inside
the blocks too (prefill's ``seq_inner``: 3 heads, where ``rules_for``
sets it, and GQA under the override ``RULES``): attention over each
rank's query rows against the all-gathered K/V, the MLP and the head on
the rows, the logits split along the sequence (``_prefill_misses``); so
do seamless-m4t-medium, mixtral-8x7b and llava-next-mistral-7b prefills
under the same override (the encoder's rows and cross-attention's
gathered memory, a window and MoE's split experts inside the rows'
region, a VLM's positions at the offset), and rwkv6-1.6b and zamba2-7b
prefills (RWKV's mixes and Mamba2 whole on every model rank over the
gathered sequence, each keeping its rows; zamba2's shared attention on
the rows); two
seamless-m4t-medium prefills (``LENGTHS``, ``_lengths``)
have frames of another length than the tokens, so that one stream splits
and the other, of odd length, stays whole. Four more decode cells split the caches
along their sequence (flash-decode: llama3.2-3b at batch 4 and at batch
1, mixtral-8x7b's sliding-window ring, seamless-m4t-medium's self and
cross caches), from seeded cache rows at positions that straddle the
shards (``POSITIONS``). Each cell runs under a ``Spy`` on the layer
gather, and ``_held_gathers`` holds on every rank what the gathers did:
the whole bytes alive at once, the gradient buffers and the
collectives; ``_held_decode`` holds a serve step's split: no cache,
``wkv`` or ``ssm`` leaf gathered, a cache's storage 1/4 of the whole,
the model and combine all-reduces the code's count; ``_held_region``
holds a train or prefill step's flops, its model all-reduces, its
all-gathers and reduce-scatters of the sequence (and their bytes) and
the block inputs remat holds to the code's count; the collectives of
``ISSUED_CELLS`` are recorded as issued (``Issued``), for the dry run's to
be held to them. Then
``_gather_cases``: one unit's gather and backward against the whole
path, and three planted faults that must break it; the model region's
and the sequence split's (``_plants``, seven), ``seq_inner``'s
(``_inner_plants``, five) and the serve step's (``_decode_plants``)
planted faults.
Then
``pipeline_apply`` over a 4-rank "stage" mesh: forward within 1e-5 and
gradient within 1e-4 of the sequential ones. Any rank's failure raises,
and the script exits non-zero; rank 0 writes a summary, with every
rank's gather reports, to OUT.json. JAX-free: it imports only the port.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import json
import os
import re
import sys
import tempfile
import threading
import weakref

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
    # the other remat settings: "none" keeps every gathered layer alive for
    # the backward, "dots" recomputes all but the matmuls' outputs
    ("llama3.2-3b", ("t", "train", 32, 8), "remat_none"),
    ("llama3.2-3b", ("t", "train", 32, 8), "remat_dots"),
    # the model axis splits the SSM and RWKV heads (the leaves whose split
    # dim is not whole heads), and MQA's one KV head stays whole on every
    # model rank, its wk/wv gradient summed over "model"
    ("rwkv6-1.6b", ("t", "train", 32, 8), ""),
    ("zamba2-7b", ("t", "train", 32, 8), ""),
    ("llama3.2-3b", ("t", "train", 32, 8), "mqa"),
    # the model axis splits the residual stream's sequence (Megatron-SP)
    # in every train and prefill cell: here an attention whose 3 heads do
    # not divide the model size, which gathers its input and takes its own
    # rows of its output, and a VLM's patches and tokens split as one
    # sequence
    ("llama3.2-3b", ("t", "train", 32, 8), "heads3"),
    ("llava-next-mistral-7b", ("p", "prefill", 32, 4), ""),
    # prefill's seq_inner: the blocks keep the sequence on "model" inside
    # too, attention over this rank's query rows against the gathered K/V
    # (B3 at the rows' offset), the MLP and the head on the rows: where
    # the rules set it (3 heads that do not divide the model size) and
    # where an override does (GQA, the genome's route)
    ("llama3.2-3b", ("p", "prefill", 32, 4), "heads3"),
    ("llama3.2-3b", ("p", "prefill", 32, 4), "seq_inner"),
    # and under the same override: enc-dec self-attention over the
    # encoder's rows and cross-attention against the gathered memory, a
    # sliding window cut at the rows' offset and MoE's experts split
    # inside the rows' region, a VLM's positions sliced at the offset
    ("seamless-m4t-medium", ("p", "prefill", 32, 4), "inner"),
    ("mixtral-8x7b", ("p", "prefill", 64, 4), "inner"),
    ("llava-next-mistral-7b", ("p", "prefill", 32, 4), "inner"),
    # and the blocks that read the whole sequence: RWKV's time and channel
    # mix and Mamba2 (with zamba2's shared attention on the rows) whole on
    # every model rank over the gathered sequence, each keeping its rows
    ("rwkv6-1.6b", ("p", "prefill", 32, 4), "inner"),
    ("zamba2-7b", ("p", "prefill", 32, 4), "inner"),
    # flash-decode: the caches split along their sequence over "model"
    # (two shards of 32), at global batch 1 over "data" and "model" (four
    # of 16), a sliding window's ring (two of 16), and enc-dec's self and
    # cross caches; each from a state of seeded cache rows (POSITIONS)
    ("llama3.2-3b", ("d", "decode", 64, 4), ""),
    ("llama3.2-3b", ("d", "decode", 64, 1), "batch1"),
    ("mixtral-8x7b", ("d", "decode", 64, 4), ""),
    ("seamless-m4t-medium", ("d", "decode", 64, 4), ""),
]
# a variant's config overrides and compress_grads
VARIANTS = {"": ({}, False), "adafactor": ({"optimizer": "adafactor"}, False),
            "compress": ({}, True), "remat_none": ({"remat": "none"}, False),
            "remat_dots": ({"remat": "dots"}, False),
            "mqa": ({"num_kv_heads": 1}, False), "batch1": ({}, False),
            "heads3": ({"num_heads": 3, "num_kv_heads": 3}, False),
            "seq_inner": ({"num_kv_heads": 2}, False), "inner": ({}, False)}
# a variant's overrides of the rules (``rules_for``'s, the genome's route)
RULES = {"seq_inner": {"seq_inner": "model"}, "inner": {"seq_inner": "model"}}
# the decode cells that start from seeded cache rows (every cache leaf,
# enc-dec's cross_k/cross_v too, ``seeded_state``) at these per-slot
# positions, which straddle the shards' boundaries over the 3 steps:
# llama's slot 0 has no live row on shard 1 and slot 1 writes rows 30, 31
# and 32 across it; at batch 1 shard 3 stays empty and the writes cross
# from shard 1 to 2; mixtral's ring of 32 has slot 1 cross from shard 0
# to 1, slot 2 wrap to row 0, slot 3 live past the wrap
POSITIONS = {"llama3.2-3b/decode": [0, 30, 32, 60],
             "llama3.2-3b/decode/batch1": [30],
             "mixtral-8x7b/decode": [5, 14, 31, 40],
             "seamless-m4t-medium/decode": [0, 30, 32, 60]}
# enc-dec prefills whose frames are not as long as the tokens (tokens,
# frames), under the rules of a 32-token prefill ("seq" on "model"): each
# stream splits by its own length, the odd one stays whole, and the
# memory crosses between the two layouts (``transformer._forward``)
LENGTHS = {"seamless-m4t-medium/prefill/frames31": (32, 31),
           "seamless-m4t-medium/prefill/tokens31": (31, 32)}
# the share of a train state leaf's elements allowed beyond 1e-5 of its
# scale (``mismatches``)
TRAIN_OUTLIERS = 1e-3
RANKS = 4


def cell_key(arch: str, cell: tuple, variant: str) -> str:
    """The cell's name, and the prefix of its leaves in REF.npz."""
    return f"{arch}/{cell[1]}" + (f"/{variant}" if variant else "")


def decode_tokens(batch: int, t: int) -> np.ndarray:
    """The tokens of a decode cell's step ``t``."""
    return np.arange(batch, dtype=np.int32) * 37 + 11 * t


# the leaves of a decode state that hold cache rows (their sequence axis)
CACHE_KEYS = ("kv", "self", "attn", "cross_k", "cross_v")


def seeded_state(state: dict, positions: list, seed: int = 0) -> dict:
    """A decode state (numpy, of ``init_decode_state``'s structure) whose
    cache rows are seeded normal draws in each leaf's dtype (a mask that
    reads a row it should not then shows) and whose positions are
    ``positions``."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, val in state.items():
        if key == "pos":
            out[key] = np.asarray(positions, np.int32)
        elif key in CACHE_KEYS:
            out[key] = {k: rng.standard_normal(v.shape).astype(v.dtype)
                        for k, v in val.items()} if isinstance(val, dict) \
                else rng.standard_normal(val.shape).astype(val.dtype)
        else:
            out[key] = val
    return out


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
# Spies on the layer gather (parallel/sharding.py LayerShards)
# ---------------------------------------------------------------------------

# the mesh dim that splits every cell's batch ("data"; the rules put
# "batch" there, and each cell's rows divide over its 2 ranks)
BATCH_DIMS = (0,)
# the mesh dim the model-parallel region splits over ("model")
MODEL_DIM = 1
# the stacked trees of the layer loops, and a unit's leading layer axes
UNIT_AXES = {"layers": 1, "encoder": 1, "groups": 2, "tail": 1}
# the rules' activation axes by which a block keeps its model chunk
# (``transformer.model_roles``)
REGION_AXES = ("act_heads", "act_kv_heads", "act_ffn", "act_vocab",
               "rwkv_heads", "ssm_heads", "ssm_inner")


# the cells whose collectives the dry run (``repro_torch.launch.dryrun``)
# must issue alike, rank by rank (``tests/_torch_dryrun_world.py gloo``)
ISSUED_CELLS = [("llama3.2-3b", ("t", "train", 32, 8), ""),
                ("llama3.2-3b", ("p", "prefill", 32, 4), "seq_inner"),
                ("mixtral-8x7b", ("p", "prefill", 64, 4), ""),
                ("rwkv6-1.6b", ("d", "decode", 64, 4), "")]
# c10d's ops and the functional collectives, by kind
_ISSUED_KINDS = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
                 "_reduce_scatter_base_": "reduce-scatter",
                 "all_reduce": "all-reduce",
                 "all_gather_into_tensor": "all-gather",
                 "reduce_scatter_tensor": "reduce-scatter"}


class Issued:
    """A dispatch mode that records every collective a step issues on the
    gloo world, as ``(kind, result bytes, group size)``: c10d's result
    tensors (its first argument) and its process group, a functional
    collective's returned tensor and its group's name."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        seen = self.seen = collections.Counter()

        def nbytes(x) -> int:
            if isinstance(x, torch.Tensor):
                return x.numel() * x.element_size()
            if isinstance(x, (list, tuple)):
                return sum(nbytes(y) for y in x)
            return 0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                op = func._opname
                if func.namespace == "c10d" and op in _ISSUED_KINDS:
                    group = next(a for a in args
                                 if isinstance(a, torch.ScriptObject))
                    n = dist.ProcessGroup.unbox(group).size()
                    seen[(_ISSUED_KINDS[op], nbytes(args[0]), n)] += 1
                elif func.namespace == "_c10d_functional" \
                        and op in _ISSUED_KINDS:
                    from torch.distributed.distributed_c10d import \
                        _resolve_process_group

                    name = [a for a in args if isinstance(a, str)][-1]
                    n = _resolve_process_group(name).size()
                    seen[(_ISSUED_KINDS[op], nbytes(out), n)] += 1
                elif func.namespace in ("c10d", "_c10d_functional") \
                        and op not in ("wait_tensor", "barrier",
                                       "_wrap_tensor_autograd"):
                    raise AssertionError(f"collective {func} not recorded")
                return out

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    def report(self) -> list:
        return sorted([*k, n] for k, n in self.seen.items())


class Spy:
    """What the gathers did on this rank while installed: the most bytes
    of whole leaves alive at once (weak references to every leaf a gather
    returns), the gradient buffers the train step hands its model, that
    model, and the all-gathers and reduce-scatters issued; the
    model-parallel region's collectives (``region``, ``MODEL``'s counts
    when it was left); the most bytes of tensors handed to
    ``torch.utils.checkpoint`` alive at once (``saved_peak``: remat's
    block inputs, each counted once, held until its block's backward);
    and, of a serve step, the storage and shape of each state leaf
    ``decode_step`` computed on (``decoded``, a step a dict) and the shape
    of every DTensor redistributed (``redistributed``)."""

    def __init__(self):
        self.alive = self.peak = 0
        self.saved, self.saved_alive, self.saved_peak = {}, 0, 0
        self.grads = None
        self.model = None
        self.issued = collections.Counter()
        self.region = None
        self.decoded = []  # each decode step's state: {path: (ptr, shape)}
        self.redistributed = []  # each DTensor redistribution's shape

    def watch(self, t) -> None:
        self.alive += t.nbytes
        self.peak = max(self.peak, self.alive)
        weakref.finalize(t, self._gone, t.nbytes)

    def _gone(self, n: int) -> None:
        self.alive -= n

    def keep(self, t) -> None:
        """``t``, a tensor handed to checkpoint, alive until collected."""
        if id(t) in self.saved:
            return
        self.saved[id(t)] = t.nbytes
        self.saved_alive += t.nbytes
        self.saved_peak = max(self.saved_peak, self.saved_alive)
        weakref.finalize(t, self._unsaved, id(t))

    def _unsaved(self, key: int) -> None:
        self.saved_alive -= self.saved.pop(key)

    def __enter__(self):
        from repro_torch.models import transformer as T
        from repro_torch.parallel.sharding import GATHER, MODEL

        GATHER.reset()
        MODEL.reset()
        GATHER.watch = self.watch
        self._undo = [(T, "ShardedLM", T.ShardedLM)]
        spy = self

        class Recorded(T.ShardedLM):
            def __init__(self, cfg, params, grads=None, roles=None):
                super().__init__(cfg, params, grads, roles)
                spy.grads, spy.model = grads, self

        T.ShardedLM = Recorded
        from torch.distributed.tensor import DTensor

        from repro_torch._tree import flatten

        real_decode, real_redistribute = T.decode_step, DTensor.redistribute
        self._undo += [(T, "decode_step", real_decode),
                       (DTensor, "redistribute", real_redistribute)]

        def decode_step(cfg, model, state, tokens):
            spy.decoded.append({path: (t.data_ptr(), tuple(t.shape))
                                for path, t in flatten(state)})
            return real_decode(cfg, model, state, tokens)

        def redistribute(t, *a, **k):
            spy.redistributed.append(tuple(t.shape))
            return real_redistribute(t, *a, **k)
        T.decode_step = decode_step
        DTensor.redistribute = redistribute
        import torch.utils.checkpoint as ckpt

        real_checkpoint = ckpt.checkpoint
        self._undo.append((ckpt, "checkpoint", real_checkpoint))

        def checkpoint(fn, *args, **kwargs):
            for a in args:
                if isinstance(a, torch.Tensor):
                    spy.keep(a)
            return real_checkpoint(fn, *args, **kwargs)
        ckpt.checkpoint = checkpoint
        for name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
            real = getattr(dist, name)
            self._undo.append((dist, name, real))

            def counted(*a, _real=real, _name=name, **k):
                self.issued[_name] += 1
                return _real(*a, **k)
            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        from repro_torch.parallel.sharding import GATHER, MODEL

        self.region = MODEL.counts()
        GATHER.watch = None
        for mod, name, real in self._undo:
            setattr(mod, name, real)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def expected_gathers(params_meta: dict, shardings: dict, mesh,
                     roles: dict) -> dict:
    """From the global leaves' shapes, layouts and model-parallel roles
    (``transformer.model_roles``) alone: ``units`` (the layer loops'
    units), ``rest_bytes`` (the leaves outside them as gathered: whole, or
    the model chunk a leaf keeps), ``unit_bytes`` (the largest unit so
    gathered), and per pass over the model the all-gathers of the ``rest``
    and of the ``stacks`` (none over "model" where a leaf keeps its
    chunk), and the backward's reduce-scatters and all-reduces
    (``BATCH_DIMS`` sum, and "model" where a leaf's gradient is
    partial)."""
    from torch.distributed.tensor import Shard

    from repro_torch._tree import flatten
    from repro_torch.parallel.sharding import KEEP, PARTIAL

    out = collections.Counter()
    per_unit = {}
    flat_sh = dict(flatten(shardings))
    flat_roles = dict(flatten(roles))
    for path, t in flatten(params_meta):
        pl = flat_sh[path].placements
        role = flat_roles[path]
        key = path[0]
        slices = (t.shape[0] * t.shape[1] if key == "groups"
                  else t.shape[0] if key in UNIT_AXES else 1)
        split = [k for k, p in enumerate(pl)
                 if isinstance(p, Shard) and mesh.size(k) > 1
                 and not (role == KEEP and k == MODEL_DIM)]
        sums = BATCH_DIMS + ((MODEL_DIM,) if role == PARTIAL else ())
        nbytes = _nbytes(t) // (mesh.size(MODEL_DIM) if role == KEEP else 1)
        out["stacks" if key in UNIT_AXES else "rest"] += len(split) * slices
        out["reduce_scatters"] += slices * sum(k in sums for k in split)
        out["all_reduces"] += slices * sum(
            k in sums for k in range(mesh.ndim)
            if k not in split and mesh.size(k) > 1)
        if key in UNIT_AXES:
            n = t.shape[0]
            per_unit[key] = per_unit.get(key, 0) + nbytes // n
            out[f"units/{key}"] = n
        else:
            out["rest_bytes"] += nbytes
    out["units"] = sum(v for k, v in out.items() if k.startswith("units/"))
    out["unit_bytes"] = max(per_unit.values())
    return dict(out)


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


def _rules(cfg, shape, mesh, variant: str):
    """A cell's rules: ``rules_for``'s, with the variant's overrides."""
    from repro_torch.parallel.layouts import rules_for

    return rules_for(cfg, shape, mesh, RULES.get(variant))


def _inner(cfg, shape, rules, mesh) -> bool:
    """Whether a prefill keeps its stream's inner sequence on "model"
    (``sharding.seq_inner_for`` of the tokens' global shape)."""
    from repro_torch.parallel.sharding import seq_inner_for

    return shape.kind == "prefill" and seq_inner_for(
        (shape.global_batch, shape.seq_len, cfg.d_model), rules, mesh)


def _config(arch: str, cell: tuple, variant: str):
    """A cell's reduced f32 config (``accum`` 2 where it trains), its
    shape and whether it compresses its gradients."""
    from repro_torch.configs import ShapeSpec, get_config, reduced

    shape = ShapeSpec(*cell)
    overrides, compress = VARIANTS[variant]
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                              accum=2 if shape.kind == "train" else 1,
                              **overrides)
    return cfg, shape, compress


def _train_once(arch: str, cell: tuple, variant: str, ref, mesh):
    """One train step of a cell from the reference's state and batch:
    (the program, the state after it, its metrics)."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.weights import train_state_from_reference
    from repro_torch.parallel.sharding import use_mesh

    cfg, shape, compress = _config(arch, cell, variant)
    key = cell_key(arch, cell, variant) + "/"
    rules = _rules(cfg, shape, mesh, variant)
    prog = build_train_step(cfg, shape, mesh, rules, compress_grads=compress)
    state = train_state_from_reference(
        cfg, _torch(_tree(ref, key + "in_state")), "cpu",
        shardings=prog.in_shardings[0])
    with use_mesh(mesh, rules):
        state, m = prog.jitted()(state, _torch(_tree(ref, key + "batch")))
    return prog, state, m


def _train_mismatches(arch, cell, variant, ref, state, m) -> list[str]:
    """A train step's loss, grad norm and state against the reference's."""
    from repro_torch.models.weights import state_to_numpy

    key = cell_key(arch, cell, variant) + "/"
    what = key[:-1] + " "
    rmetrics = _tree(ref, key + "metrics")
    if sorted(m) != sorted(rmetrics):
        return [f"{what}metrics {sorted(m)} != {sorted(rmetrics)}"]
    bad = []
    for k in ("loss", "grad_norm"):
        if k in rmetrics:
            got, want_k = float(m[k]), float(rmetrics[k])
            if abs(got - want_k) > 1e-5 * abs(want_k):
                bad.append(f"{what}{k} {got} != {want_k}")
    return bad + mismatches(flat(state_to_numpy(state)),
                            flat(_tree(ref, key + "out_state")), what,
                            outliers=TRAIN_OUTLIERS)


def _unsplit_misses(arch, cell, variant, ref, mesh, state, m,
                    bad: list[str]) -> list[str]:
    """Where a split train step's state misses the reference's: the same
    step with every block's leaves whole over "model" (each model rank
    computing the whole block; a sequence split stays) on the same mesh. The split state
    must match it under the present bounds, and it must miss the
    reference in the same leaves by at least as many elements: the miss
    is then the port's rounding against the reference's, which the split
    does not add to. Returns what fails."""
    from repro_torch.models import transformer as T
    from repro_torch.models.weights import state_to_numpy

    real = T.model_roles
    # no block keeps a chunk; a sequence split keeps its norms' sums
    T.model_roles = lambda cfg, rules, mesh, shape=None: real(
        cfg, rules.with_overrides(**{a: None for a in REGION_AXES}), mesh,
        shape)
    try:
        _, whole, wm = _train_once(arch, cell, variant, ref, mesh)
    finally:
        T.model_roles = real
    what = cell_key(arch, cell, variant) + " "
    out = mismatches(flat(state_to_numpy(state)),
                     flat(state_to_numpy(whole)), what + "vs unsplit ",
                     outliers=TRAIN_OUTLIERS)
    base = {b.split(": ")[0]: b for b in
            _train_mismatches(arch, cell, variant, ref, whole, wm)}
    for b in bad:
        leaf, _, rest = b.partition(": ")
        if leaf not in base:
            out.append(b)
        elif rest.split(" of ")[0].isdigit() and int(rest.split(" of ")[0]) \
                > int(base[leaf].split(": ")[1].split(" of ")[0]):
            out.append(f"{b}, the unsplit step {base[leaf]}")
    return out


def _cell(arch: str, cell: tuple, variant: str, ref, mesh) -> dict:
    """Runs one cell under a ``Spy`` (and a train or prefill step under a
    ``FlopCounterMode``) and holds its values to the reference's, its
    gathers to ``_held_gathers`` and its model-parallel region to
    ``_held_region`` (a train or prefill step) or ``_held_decode`` (a
    serve step); returns their report."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.steps import build_cell_program
    from repro_torch.models.transformer import model_roles

    cfg, shape, _ = _config(arch, cell, variant)
    rules = _rules(cfg, shape, mesh, variant)
    key = cell_key(arch, cell, variant) + "/"
    what = key[:-1] + " "
    train = shape.kind == "train"
    roles = model_roles(cfg, rules, mesh, shape)
    issued = (Issued() if (arch, cell, variant) in ISSUED_CELLS
              else contextlib.nullcontext())
    if train:
        with Spy() as spy, FlopCounterMode(display=False) as fc, issued:
            prog, state, m = _train_once(arch, cell, variant, ref, mesh)
        bad = _train_mismatches(arch, cell, variant, ref, state, m)
        want = expected_gathers(prog.args[0]["params"],
                                prog.in_shardings[0]["params"], mesh, roles)
        report = _held_gathers(spy, want, cfg, 1, what, state["params"])
        params = _torch(_tree(ref, key + "in_state"))["params"]
        batch = _torch(_tree(ref, key + "batch"))
        report.update(_held_region(cfg, shape, roles, spy, fc, params,
                                   batch, mesh, what))
        if bad:
            _check(_unsplit_misses(arch, cell, variant, ref, mesh, state, m,
                                   bad))
            report["misses_as_unsplit"] = bad
        if isinstance(issued, Issued):
            report["issued"] = issued.report()
        return report
    prog = build_cell_program(cfg, shape, mesh, rules)
    step = prog.jitted()
    # decode runs the decoder alone, not an enc-dec config's encoder
    want = expected_gathers({k: v for k, v in prog.args[0].items()
                             if shape.kind != "decode" or k != "encoder"},
                            prog.in_shardings[0], mesh, roles)
    params = _tree(ref, key + "params")
    if shape.kind == "prefill":
        batch = _tree(ref, key + "batch")
        with Spy() as spy, FlopCounterMode(display=False) as fc, issued:
            _, logits = _prefill_once(arch, cell, variant, ref, mesh, step)
        inner = _inner(cfg, shape, rules, mesh)
        _check(_prefill_misses(arch, cell, variant, ref, mesh, logits))
        report = _held_gathers(spy, want, cfg, 1, what)
        report.update(_held_region(cfg, shape, roles, spy, fc,
                                   _torch(params), _torch(batch), mesh, what,
                                   inner))
        report["inner"] = inner
        # the tensor dim each mesh dim splits the logits along (None:
        # whole over it)
        report["logits_split_dims"] = [getattr(p, "dim", None)
                                       for p in logits.placements]
        if isinstance(issued, Issued):
            report["issued"] = issued.report()
        return report
    with Spy() as spy, issued:
        prog, logits, state = _decode_once(arch, cell, variant, ref, mesh)
    _check(_decode_mismatches(arch, cell, variant, ref, logits, state))
    report = _held_gathers(spy, want, cfg, 3, what)
    report.update(_held_decode(cfg, shape, rules, roles, spy, state, mesh,
                               what))
    if isinstance(issued, Issued):  # of the three steps
        report["issued"] = issued.report()
    return report


def _prefill_once(arch: str, cell: tuple, variant: str, ref, mesh,
                  step=None):
    """A prefill cell's step on the reference's parameters and batch:
    (the program's function, its logits DTensor)."""
    from repro_torch.launch.steps import build_cell_program
    from repro_torch.parallel.sharding import use_mesh

    cfg, shape, _ = _config(arch, cell, variant)
    rules = _rules(cfg, shape, mesh, variant)
    key = cell_key(arch, cell, variant) + "/"
    if step is None:
        step = build_cell_program(cfg, shape, mesh, rules).jitted()
    with use_mesh(mesh, rules):
        logits = step(_tree(ref, key + "params"),
                      _torch(_tree(ref, key + "batch")))
    return step, logits


def _prefill_misses(arch, cell, variant, ref, mesh, logits) -> list[str]:
    """A prefill's logits against the reference's (every element within
    1e-5 of max), and their layout: split along the sequence over "model"
    where the rules keep the inner sequence there (``seq_inner``, the
    reference's pruned ``("batch", "seq_inner", "act_vocab")``), not
    where they do not."""
    from torch.distributed.tensor import Shard

    from repro_torch.parallel.sharding import full

    cfg, shape, _ = _config(arch, cell, variant)
    key = cell_key(arch, cell, variant)
    bad = mismatches({"": full(logits).numpy()}, {"": ref[key + "/logits"]},
                     key + " logits")
    rows = logits.placements[MODEL_DIM] == Shard(1)
    want = _inner(cfg, shape, _rules(cfg, shape, mesh, variant), mesh)
    if rows != want:
        bad.append(f"{key} logits laid out {logits.placements}: the pruned "
                   f"spec splits their sequence over 'model': {want}")
    return bad


def _decode_once(arch: str, cell: tuple, variant: str, ref, mesh):
    """Three serve steps of a decode cell: (the program, each step's
    logits as the step lays them out, the state after them). A cell of ``POSITIONS`` starts
    from the reference's seeded state, the others from the port's own
    fresh state (the reference's values, zeros, with the hybrid's conv in
    the model's dtype where the reference starts it in bf16: ROADMAP.md, a
    named divergence)."""
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models.transformer import init_decode_state
    from repro_torch.models.weights import state_to_numpy
    from repro_torch.parallel.layouts import rules_for
    from repro_torch.parallel.sharding import use_mesh

    cfg, shape, _ = _config(arch, cell, variant)
    rules = rules_for(cfg, shape, mesh)
    key = cell_key(arch, cell, variant)
    if key in POSITIONS:
        state = _torch(_tree(ref, key + "/in_state"))
    else:
        state = init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                  device="cpu")
        _check(mismatches(flat(state_to_numpy(state)),
                          flat(_tree(ref, key + "/in_state")),
                          key + " init"))
    prog = build_serve_step(cfg, shape, mesh, rules)
    step = prog.jitted()
    params = _tree(ref, key + "/params")
    logits = []
    for t in range(3):
        tokens = decode_tokens(shape.global_batch, t)
        with use_mesh(mesh, rules):
            out, state = step(params, state, torch.from_numpy(tokens))
        logits.append(out)
    return prog, logits, state


def _decode_mismatches(arch, cell, variant, ref, logits, state) -> list:
    """A decode cell's logits (every element within 1e-5 of the step's
    max), greedy tokens (equal) and state against the reference's."""
    from repro_torch.models.weights import state_to_numpy
    from repro_torch.parallel.sharding import full

    key = cell_key(arch, cell, variant)
    bad = []
    for t, got in enumerate(logits):
        got = full(got).numpy()
        want = ref[f"{key}/logits{t}"]
        bad += mismatches({"": got}, {"": want}, f"{key} logits{t}")
        if not np.array_equal(got.argmax(-1), as_f32(want).argmax(-1)):
            bad.append(f"{key} greedy tokens{t} {got.argmax(-1)} != "
                       f"{as_f32(want).argmax(-1)}")
    return bad + mismatches(flat(state_to_numpy(state)),
                            flat(_tree(ref, key + "/out_state")),
                            f"{key} state")


def decode_all_reduces(cfg, roles: dict, kv_split: bool) -> int:
    """The code's count of a serve step's collectives over the model
    region and the caches' sequence shards: three an attention over a
    split cache (``attention._split_sdpa``: the scores' max, the sum of
    their exponentials, the partial outputs), one at each split block's
    ``leave`` (the MLP's, the experts', RWKV's time and channel mixes',
    Mamba2's output projection) and the embedding's lookup over the vocab
    shards; Mamba2's split decode two more, the conv's input row joined
    (``ssm._whole_xbc``) and the gated norm's ``model_sum``. The logits'
    ``enter`` all-reduces only in a backward."""
    from repro_torch.models.transformer import hybrid_groups
    from repro_torch.parallel.sharding import KEEP

    kv = 3 if kv_split else 0

    def kept(*path) -> int:
        node = roles
        for k in path:
            node = node.get(k) if isinstance(node, dict) else None
        return int(node == KEEP)

    n = cfg.num_layers
    if cfg.family == "ssm":
        per = n * (kept("layers", "tm", "w_r") + kept("layers", "tm", "c_k"))
    elif cfg.family == "hybrid":
        ng, tail = hybrid_groups(cfg)
        mamba = 3 * kept("groups", "mamba", "A_log")
        per = ng * (kv + cfg.attn_every * mamba) + tail * mamba
    elif cfg.is_encdec:
        per = n * (2 * kv + kept("layers", "mlp", "w_up"))
    else:
        ffn = "moe" if cfg.num_experts else "mlp"
        per = n * (kv + kept("layers", ffn, "w_up"))
    return kept("embedding", "embed") + per


def _held_decode(cfg, shape, rules, roles, spy, state, mesh,
                 what: str) -> dict:
    """A serve cell's split, held on this rank over its 3 steps: every
    state leaf but Mamba2's ``conv`` was computed on in its own local
    storage (no cache, ``wkv`` or ``ssm`` leaf gathered or copied), and
    only ``conv`` was redistributed (gathered whole over "model"); each
    cache leaf's storage is 1/model of the whole along its sequence (1/4
    over "data" and "model" at global batch 1) besides the batch's split;
    the model region's and the combine's all-reduces are the code's count
    (``decode_all_reduces``)."""
    from repro_torch._tree import flatten
    from repro_torch.launch.steps import serve_layout
    from repro_torch.parallel.sharding import local

    layout = serve_layout(cfg, shape, rules, mesh, roles)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    bad = []
    here = dict(flatten(state))
    gathered = [tuple(here[p].shape) for p in layout.gathered]
    for t, seen in enumerate(spy.decoded):
        for path, (ptr, shp) in seen.items():
            if path == ("pos",):
                continue
            mine = local(here[path])
            if path in layout.gathered:  # its channels whole
                whole = tuple(mine.shape[:-1]) + (here[path].shape[-1],)
                if ptr == mine.data_ptr() or shp != whole:
                    bad.append(f"{what}step {t}: {path} computed on {shp}, "
                               f"not gathered whole {whole}")
            elif ptr != mine.data_ptr() or shp != tuple(mine.shape):
                bad.append(f"{what}step {t}: {path} computed on {shp}, not "
                           f"on its local storage {tuple(mine.shape)}")
    if sorted(spy.redistributed) != sorted(gathered * len(spy.decoded)):
        bad.append(f"{what}redistributed {spy.redistributed}, the code "
                   f"gathers {gathered} a step")
    fractions = {}
    for path, t in here.items():
        if path[0] not in CACHE_KEYS:
            continue
        whole, mine = t.numel(), local(t).numel()
        seq = np.prod([sizes[a] for a in layout.kv_seq], dtype=int)
        batch = np.prod([sizes[a] for a in layout.batch], dtype=int)
        fractions["/".join(path)] = mine / whole
        want_seq = sizes["model"] * (sizes["data"]
                                     if shape.global_batch == 1 else 1)
        if seq != want_seq or whole != mine * seq * batch:
            bad.append(f"{what}{path}: {mine} of {whole} elements here, "
                       f"its sequence over {layout.kv_seq}")
    code = 3 * decode_all_reduces(cfg, roles, bool(layout.kv_seq))
    if spy.region["all_reduces"] != code:
        bad.append(f"{what}{spy.region['all_reduces']} model and combine "
                   f"all-reduces in 3 steps, the code gives {code}")
    _check(bad)
    return {"model_all_reduces": spy.region["all_reduces"],
            "model_all_reduces_code": code,
            "model_bytes": spy.region["bytes"],
            "kv_seq_axes": list(layout.kv_seq),
            "cache_local_fraction": fractions,
            "gathered_state": ["/".join(p) for p in layout.gathered],
            "redistributed": len(spy.redistributed)}


# ---------------------------------------------------------------------------
# The model-parallel region: flops and collectives, against the code's count
# ---------------------------------------------------------------------------


def _rows(cfg, shape, mesh) -> tuple[int, int, list]:
    """(accum, rows a microbatch on this rank, the first row of each of
    its microbatches): each microbatch's rows split over "data"."""
    accum = max(cfg.accum, 1) if shape.kind == "train" else 1
    rows = shape.global_batch // accum
    shares = mesh.size(BATCH_DIMS[0])
    per = rows // shares
    share = mesh.get_coordinate()[BATCH_DIMS[0]]
    return accum, per, [j * rows + share * per for j in range(accum)]


def one_device_flops(cfg, shape, params: dict, batch: dict, mesh) -> int:
    """The flops (``FlopCounterMode``) of the same step's model on this
    rank's rows computed whole on one device, as a 1x1 mesh computes
    them: each microbatch's ``forward_loss`` and backward (remat as the
    config says), or the prefill's forward."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import transformer as T

    accum, per, starts = _rows(cfg, shape, mesh)
    params = {k: v for k, v in params.items()}
    model = T.TransformerLM.from_stacked(cfg, params)
    with FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            T.bind_stacked_grads(model, params)
            for lo in starts:
                mb = {k: v[lo:lo + per] for k, v in batch.items()}
                loss, _ = T.forward_loss(cfg, model, mb)
                (loss / accum).backward()
        else:
            T.forward(cfg, model, {k: v[starts[0]:starts[0] + per]
                                   for k, v in batch.items()})
    return fc.get_total_flops()


def _attention_flops(cfg, rows: int, s: int) -> tuple[int, int]:
    """(forward, backward) flops of one whole attention (``FlopCounterMode``)
    over ``rows`` rows of ``s`` positions on one device: the share of a
    block whose heads do not split, which every model rank computes."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import attention as attn
    from repro_torch.models.transformer import DTYPES
    from repro_torch.parallel.sharding import init_from_defs

    p = init_from_defs(torch.Generator().manual_seed(0),
                       attn.attention_defs(cfg), DTYPES[cfg.dtype])
    x = torch.randn(rows, s, cfg.d_model, requires_grad=True)
    for t in p.values():
        t.requires_grad_(True)
    with FlopCounterMode(display=False) as fwd:
        out = attn.attention(cfg, p, x, causal=True,
                             window=cfg.sliding_window)
    with FlopCounterMode(display=False) as bwd:
        out.sum().backward()
    return fwd.get_total_flops(), bwd.get_total_flops()


def _layer_flops(cfg, rows: int, s: int) -> int:
    """Forward flops (``FlopCounterMode``) of one RWKV layer (time and
    channel mix) or one Mamba2 layer, whole, over ``rows`` rows of ``s``
    positions on one device: what every model rank computes of such a
    layer under prefill's ``seq_inner``, on the gathered sequence."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import transformer as T

    model = T.TransformerLM.from_stacked(
        cfg, T.init_param_tree(cfg, torch.Generator().manual_seed(0),
                               device="cpu"))
    x = torch.randn(rows, s, cfg.d_model, dtype=T.DTYPES[cfg.dtype])
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        if cfg.family == "ssm":
            T._rwkv_block(cfg, model.layers[0], x, mode="exec")
        else:
            layer = (model.groups[0][0] if len(model.groups)
                     else model.tail[0])
            T._mamba_block(cfg, layer, x, mode="exec")
    return fc.get_total_flops()


def replicated_flops(cfg, shape, roles: dict, mesh, inner: bool = False
                     ) -> int:
    """The code's count of the flops of the matmuls that every model rank
    computes whole, on this rank's rows: a train step runs each block's
    forward once, and again in remat's recompute, and its backward takes
    two products of each (the input's gradient and the weight's), a
    prefill the forward alone. MQA's K/V projections (``wk``/``wv``
    ``PARTIAL``), MoE's router (f32), RWKV's receptance ``c_r`` and decay
    LoRA ``decay_A``, Mamba2's B and C columns of ``in_proj`` and the
    scan's C·Bᵀ, the frontends' projections (outside the blocks, over
    every frame or patch; their inputs take no gradient), and an
    attention whose heads do not split (``_attention_flops``); all else is
    split. A sequence split of the residual stream changes none of it:
    every block computes on the gathered sequence. Under ``inner``
    (prefill's ``seq_inner``) attention, the MLP and the head compute on
    this rank's rows: 1/model of the same rows' flops on one device, as a
    split is; but cross-attention projects its K and V from the whole
    memory on every rank, and RWKV's layers and Mamba2's are whole on
    every model rank over the gathered sequence (``_layer_flops``; zamba2's
    shared attention on the rows, as llama's)."""
    from repro_torch._tree import flatten
    from repro_torch.parallel.sharding import KEEP, PARTIAL

    accum, per, _ = _rows(cfg, shape, mesh)
    s, d, n = shape.seq_len, cfg.d_model, cfg.num_layers
    tokens = per * s
    flat_roles = dict(flatten(roles))

    def mm(t, a, b):
        return 2 * t * a * b

    train = shape.kind == "train"
    passes = ((1 if cfg.remat == "none" else 2) + 2) if train else 1
    if inner and cfg.family in ("ssm", "hybrid"):
        return n * _layer_flops(cfg, per, s)
    if cfg.family == "ssm":
        layer = mm(tokens, d, d) + mm(tokens, d, cfg.rwkv_decay_rank)
    elif cfg.family == "hybrid":
        cs = min(cfg.ssm_chunk, s) if s % min(cfg.ssm_chunk, s) == 0 else s
        layer = mm(tokens, d, 2 * cfg.ssm_state) + (tokens // cs) * mm(
            cs, cfg.ssm_state, cs)
    elif cfg.num_experts:
        layer = mm(tokens, d, cfg.num_experts)
    elif flat_roles.get(("layers", "attn", "wk")) == PARTIAL:
        layer = 2 * mm(tokens, d, cfg.num_kv_heads * cfg.resolved_head_dim)
    else:
        layer = 0
    out = accum * passes * n * layer
    if cfg.is_encdec:  # frames as long as the tokens
        out += accum * (2 if train else 1) * mm(tokens, d, d)
    if cfg.is_encdec and inner:  # cross-attention's K/V of the whole memory
        out += n * 2 * mm(tokens, d, cfg.num_kv_heads * cfg.resolved_head_dim)
    if cfg.frontend == "vision":  # the patches in front of the tokens
        patches = min(cfg.frontend_tokens, s // 2)
        out += accum * (2 if train else 1) * mm(per * patches, d, d)
    if cfg.family == "dense" and not cfg.is_encdec and not inner and \
            flat_roles.get(("layers", "attn", "wq")) != KEEP:
        fwd, bwd = _attention_flops(cfg, per, s)
        again = 0 if not train or cfg.remat == "none" else 1
        out += accum * n * ((1 + again) * fwd + (bwd if train else 0))
    return out


def _kept(roles: dict, *path) -> bool:
    from repro_torch.parallel.sharding import KEEP

    node = roles
    for k in path:
        node = node.get(k) if isinstance(node, dict) else None
    return node == KEEP


def seq_units(cfg, shape, roles: dict, inner: bool = False) -> list:
    """The units of the layer loops (the blocks remat wraps) as a step
    under a sequence split runs them: each a list of its sublayers in
    order, a sublayer ``(enters, out, split, sums, kv)``: the lengths of
    the streams its ``enter`` gathers (cross-attention's memory too), the
    length of its output's stream (None: no ``leave``), whether it keeps a
    model chunk (its output partial), its ``model_sum`` all-reduces
    (Mamba2's gated norm, where it keeps its heads) and its K/V
    all-gathers of the sequence (attention under ``inner``, prefill's
    ``seq_inner``: on this rank's rows, with neither ``enter`` nor
    ``leave``, as the MLP). The tokens' stream is the shape's length (a
    VLM's patches and tokens together), an enc-dec encoder's frames as
    long."""
    from repro_torch.models.transformer import hybrid_groups

    s = t = shape.seq_len
    n = cfg.num_layers

    def sub(split, enters=(s,), out=s, sums=0):
        return (tuple(enters), out, bool(split), sums, 0)

    def inside(*path, kv=0, memory=()):
        """An attention (``kv``: its K/V all-gathers under ``inner``;
        cross-attention's ``memory``) or an MLP."""
        if inner:
            return (memory, None, False, 0, kv)
        return sub(_kept(roles, *path), (s,) + memory)

    if cfg.family == "ssm":
        return [[sub(_kept(roles, "layers", "tm", "w_r")),
                 sub(_kept(roles, "layers", "tm", "c_k"))]] * n
    if cfg.family == "hybrid":
        ng, tail = hybrid_groups(cfg)
        mk = _kept(roles, "groups", "mamba", "A_log")
        mamba = sub(mk, sums=int(mk))
        return ([[inside("shared_attn", "attn", "wq", kv=2)]
                 + [mamba] * cfg.attn_every] * ng + [[mamba]] * tail)
    if cfg.is_encdec:
        enc = [inside("encoder", "attn", "wq", kv=2),
               inside("encoder", "mlp", "w_up")]
        dec = [inside("layers", "attn", "wq", kv=2),
               inside("layers", "xattn", "wq", memory=(t,)),
               inside("layers", "mlp", "w_up")]
        return [enc] * cfg.encoder_layers + [dec] * n
    ffn = (sub(_kept(roles, "layers", "moe", "w_up")) if cfg.num_experts
           else inside("layers", "mlp", "w_up"))
    return [[inside("layers", "attn", "wq", kv=2), ffn]] * n


SEQ_COUNTS = ("all_gathers", "gathered_bytes", "reduce_scatters",
              "scattered_bytes")


def seq_collectives(cfg, shape, roles: dict, mesh, inner: bool = False
                    ) -> dict:
    """The code's count of a train or prefill step's all-gathers and
    reduce-scatters of the sequence over "model" (``MODEL``), with the
    bytes of the whole sequence each one moves, where every stream splits
    (``seq_units``). A sublayer's ``enter`` all-gathers its inputs in the
    forward and reduce-scatters their gradients in the backward where it
    keeps a chunk (else takes its own rows); its ``leave`` reduce-scatters
    where it keeps a chunk (else takes its own rows) and all-gathers the
    gradient in the backward. Remat's recompute (remat full or dots) runs
    each unit's forward again but for its last ``leave``, whose output
    only the residual add reads. Outside the units: the lookup's
    reduce-scatter into this rank's rows (its own rows where the table is
    whole) and its gradient's all-gather, the logits' all-gather and its
    gradient's reduce-scatter (where the vocab splits). Under ``inner``
    (prefill's ``seq_inner``) an attention all-gathers its K and V, each
    of the sequence's length and K·hd wide, and the head computes on the
    rows."""
    from repro_torch.models.transformer import DTYPES

    accum, per, _ = _rows(cfg, shape, mesh)
    item = DTYPES[cfg.dtype].itemsize
    width = cfg.d_model * item * per
    kv_width = cfg.num_kv_heads * cfg.resolved_head_dim * item * per
    train = shape.kind == "train"
    again = train and cfg.remat != "none"
    vocab = _kept(roles, "embedding", "embed")
    s = shape.seq_len
    out = collections.Counter()

    def add(kind, length, times=1, wide=width):
        out[kind + "s"] += times
        out[("gathered" if kind == "all_gather" else "scattered")
            + "_bytes"] += times * length * wide

    for unit in seq_units(cfg, shape, roles, inner):
        for j, (enters, length, split, _, kv) in enumerate(unit):
            for e in enters:
                add("all_gather", e, 1 + again)
                if train and split:
                    add("reduce_scatter", e)
            if kv:
                add("all_gather", s, kv, kv_width)
            if split:
                last = j == len(unit) - 1
                add("reduce_scatter", length, 1 + (again and not last))
            if train:
                add("all_gather", length)
    if not inner:
        add("all_gather", s)  # the logits' input
    if vocab:
        add("reduce_scatter", s)  # the lookup
    if train:
        add("all_gather", s)  # the lookup's gradient
        if vocab:
            add("reduce_scatter", s)  # the logits' input's gradient
    return {k: accum * out[k] for k in SEQ_COUNTS}


def model_all_reduces(cfg, shape, roles: dict, inner: bool = False) -> int:
    """The code's count of the model-parallel region's all-reduces in one
    step whose streams split along their sequence: the loss's max and sum
    over the vocab shards in the forward of each microbatch, and Mamba2's
    gated-norm ``model_sum`` where it keeps its heads, in its forward, in
    remat's recompute and in its backward. ``enter`` and ``leave``
    all-gather and reduce-scatter instead (``seq_collectives``)."""
    train = shape.kind == "train"
    sums = sum(u[3] for unit in seq_units(cfg, shape, roles, inner)
               for u in unit)
    if not train:
        return sums
    again = 0 if cfg.remat == "none" else 1
    return cfg.accum * (sums * (2 + again) + 2)


def saved_boundary_bytes(cfg, shape, mesh, split: bool = True) -> int:
    """The code's count of the bytes remat (full or dots) holds at the
    block boundaries of one microbatch: each unit's input, this rank's
    rows of its stream (``split``; the whole stream without), and an
    enc-dec decoder's memory once."""
    from repro_torch.models.transformer import DTYPES, hybrid_groups

    _, per, _ = _rows(cfg, shape, mesh)
    rows = shape.seq_len // (mesh.size(MODEL_DIM) if split else 1)
    one = per * rows * cfg.d_model * DTYPES[cfg.dtype].itemsize
    if cfg.family == "hybrid":
        ng, tail = hybrid_groups(cfg)
        return (ng + tail) * one
    if cfg.is_encdec:
        return (cfg.encoder_layers + cfg.num_layers + 1) * one
    return cfg.num_layers * one


def _held_region(cfg, shape, roles, spy, fc, params, batch, mesh,
                 what: str, inner: bool = False) -> dict:
    """This rank's flops (the step under ``fc``) against the same rows'
    on one device (``one_device_flops``): the ratio must be what the
    code's count gives, 1/model of the split matmuls and the whole of the
    replicated ones (``replicated_flops``); its model-region all-reduces
    (``model_all_reduces``) and its sequence all-gathers and
    reduce-scatters with their bytes (``seq_collectives``) the code's
    count; and a train step's remat-saved block inputs
    (``Spy.saved_peak``, remat full or dots) the code's count, this
    rank's rows of each stream (``saved_boundary_bytes``). ``inner``:
    a prefill under ``seq_inner``."""
    m = mesh.size(MODEL_DIM)
    flops = fc.get_total_flops()
    whole = one_device_flops(cfg, shape, params, batch, mesh)
    rep = replicated_flops(cfg, shape, roles, mesh, inner)
    out = {"flops": flops, "flops_one_device": whole,
           "flop_ratio": flops / whole,
           "flop_ratio_code": ((whole - rep) / m + rep) / whole,
           "replicated_flops": rep,
           "model_all_reduces": spy.region["all_reduces"],
           "model_all_reduces_code": model_all_reduces(cfg, shape, roles,
                                                       inner),
           "model_bytes": spy.region["bytes"],
           "seq": {k: spy.region[k] for k in SEQ_COUNTS},
           "seq_code": seq_collectives(cfg, shape, roles, mesh, inner)}
    bad = []
    if flops * m != whole - rep + m * rep:
        bad.append(f"{what}flops {flops} of one device's {whole}, the code "
                   f"gives ({whole} - {rep}) / {m} + {rep}")
    if out["model_all_reduces"] != out["model_all_reduces_code"]:
        bad.append(f"{what}{out['model_all_reduces']} model all-reduces, "
                   f"the code gives {out['model_all_reduces_code']}")
    if out["seq"] != out["seq_code"]:
        bad.append(f"{what}sequence collectives {out['seq']}, the code "
                   f"gives {out['seq_code']}")
    if shape.kind == "train" and cfg.remat != "none":
        out["saved_bytes"] = spy.saved_peak
        out["saved_bytes_code"] = saved_boundary_bytes(cfg, shape, mesh)
        out["saved_bytes_unsplit"] = saved_boundary_bytes(cfg, shape, mesh,
                                                          split=False)
        if out["saved_bytes"] != out["saved_bytes_code"]:
            bad.append(f"{what}remat held {out['saved_bytes']} bytes of "
                       f"block inputs at once, the code gives "
                       f"{out['saved_bytes_code']}")
    _check(bad)
    return out


def _held_gathers(spy: Spy, want: dict, cfg, steps: int, what: str,
                  params=None) -> dict:
    """One cell's gathers on this rank, held: (a) the most bytes of whole
    leaves alive at once at most the leaves outside the layer loops whole
    and the largest unit (under remat full; remat none keeps every
    gathered layer for the backward, and is only reported); (b) with
    ``params`` (a train step's), gradient buffers of exactly the local
    shards' shapes and bytes, into which every shard's gradient went;
    (c) the gathers' calls and collectives the code's count: a forward
    gathers the rest and each unit once, remat full's recompute each unit
    again, a backward reduces the rest and each unit once; a train step
    runs ``cfg.accum`` microbatches, a decode cell ``steps`` steps."""
    from repro_torch._tree import leaves
    from repro_torch.parallel.sharding import GATHER, local

    got = GATHER.counts()
    units = want["units"]
    if params is not None:
        again = 2 if cfg.remat != "none" else 1
        code = {"calls": cfg.accum * (1 + again * units),
                "all_gathers": cfg.accum * (want["rest"]
                                            + again * want["stacks"]),
                "reductions": cfg.accum * (1 + units),
                "reduce_scatters": cfg.accum * want["reduce_scatters"],
                "all_reduces": cfg.accum * want["all_reduces"]}
    else:
        code = {"calls": steps * (1 + units),
                "all_gathers": steps * (want["rest"] + want["stacks"]),
                "reductions": 0, "reduce_scatters": 0, "all_reduces": 0}
    bad = [f"{what}gather {k} {got[k]}, the code gives {v}"
           for k, v in code.items() if got[k] != v]
    # the layer gather's and the sequence split's (MODEL) collectives
    issued = {"all_gathers": spy.issued["all_gather_into_tensor"],
              "reduce_scatters": spy.issued["reduce_scatter_tensor"]}
    bad += [f"{what}{v} {k} issued, {got[k]} + {spy.region[k]} counted"
            for k, v in issued.items() if v != got[k] + spy.region[k]]
    bound = want["rest_bytes"] + want["unit_bytes"]
    if cfg.remat != "none" and spy.peak > bound:
        bad.append(f"{what}{spy.peak} bytes of whole leaves alive at once, "
                   f"beyond the rest and one unit's {bound}")
    out = {"peak_gathered_bytes": spy.peak, "bound_bytes": bound,
           "rest_bytes": want["rest_bytes"], "unit_bytes": want["unit_bytes"],
           "remat": cfg.remat, "counts": got}
    if params is not None:
        grads = leaves(spy.grads)
        shards = [local(p) for p in leaves(params)]
        out["grad_bytes"] = sum(g.nbytes for g in grads)
        out["local_param_bytes"] = sum(p.nbytes for p in shards)
        if [g.shape for g in grads] != [p.shape for p in shards] \
                or out["grad_bytes"] != out["local_param_bytes"]:
            bad.append(f"{what}gradient buffers {out['grad_bytes']} bytes, "
                       f"the local shards {out['local_param_bytes']}")
        storage = {g.untyped_storage().data_ptr() for g in grads}
        model = spy.model
        for unit in [model.rest] + [u for us in model.units.values()
                                    for u in us]:
            if any(s.grad is None
                   or s.grad.untyped_storage().data_ptr() not in storage
                   for s in unit.parts):
                bad.append(f"{what}a shard's gradient outside the buffers")
                break
    _check(bad)
    return out


def _gather_cases(mesh) -> dict:
    """One unit of four leaves laid out over "data" only, "model" only,
    both and neither, each used by a block (remat full) on this rank's
    rows of a batch split over "data". Each shard's gradient through the
    gather and its backward against the whole-gather path's (the leaf
    whole on every rank, its gradient summed over "data", then this rank's
    chunk), within 1e-6 of the gradient's max. Three planted faults must
    each break that: summing over "model" too, not summing over "data",
    and a gather whose output a block keeps (whole bytes alive after it)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils.checkpoint import checkpoint

    from repro_torch.parallel.sharding import (
        LayerShards, data_parallel, local_chunk)

    layouts = {"both": (Shard(0), Shard(1)),
               "data": (Shard(0), Replicate()),
               "model": (Replicate(), Shard(1)),
               "neither": (Replicate(), Replicate())}
    gen = torch.Generator().manual_seed(0)
    whole = {k: torch.randn(8, 8, generator=gen) for k in layouts}
    x = torch.randn(8, 8, generator=gen)
    share = mesh.get_coordinate()[0]
    rows = x[4 * share:4 * share + 4]

    def loss(p):
        return sum(torch.tanh(rows @ p[k]).square().sum() for k in layouts)

    def whole_path() -> dict:
        p = {k: w.clone().requires_grad_(True) for k, w in whole.items()}
        loss(p).backward()
        out = {}
        for k, w in p.items():
            dist.all_reduce(w.grad, group=mesh.get_group(0))
            out[k] = local_chunk(w.grad, layouts[k], mesh)
        return out

    def gathered(dims, keep=None) -> tuple[dict, int]:
        spy = Spy()
        grads = {k: torch.zeros_like(local_chunk(w, layouts[k], mesh))
                 for k, w in whole.items()}
        unit = LayerShards({k: local_chunk(w, layouts[k], mesh).contiguous()
                            for k, w in whole.items()},
                           [layouts[k] for k in sorted(layouts)], mesh, grads)

        def block(_):
            p = unit.gather()
            if keep is not None:
                keep.append(p)
            return loss(p)

        with spy, data_parallel(mesh, dims):
            out = checkpoint(block, rows, use_reentrant=False)
            alive = spy.alive
            out.backward()
        return grads, alive

    want = whole_path()

    def err(got: dict) -> float:
        return max(float((got[k] - want[k]).abs().max())
                   / float(want[k].abs().max()) for k in want)

    good, alive = gathered(BATCH_DIMS)
    kept: list = []
    report = {"err": err(good), "alive_after_block": alive,
              "plants": {"sum_over_model": err(gathered((0, 1))[0]),
                         "no_sum_over_data": err(gathered(())[0]),
                         "kept_alive_bytes": gathered(BATCH_DIMS, kept)[1]}}
    plants = report["plants"]
    bad = []
    if report["err"] > 1e-6 or alive:
        bad.append(f"gather cases: error {report['err']}, {alive} bytes "
                   f"alive after the block")
    if min(plants["sum_over_model"], plants["no_sum_over_data"]) <= 1e-6 \
            or not plants["kept_alive_bytes"]:
        bad.append(f"gather cases: a planted fault passed: {plants}")
    _check(bad)
    return report


def _plants(ref, mesh) -> dict:
    """Seven faults planted in the model-parallel region, each in a train
    cell whose values must then miss the reference's (the number of
    failed checks, a planted fault must make some): ``leave``'s sum
    dropped after attention's row-split output projection (llama: each
    rank takes its rows of its partial output, where the reduce-scatter
    sums them); MQA's ``wk``/``wv`` gradient not summed
    over "model" (their roles None in place of ``PARTIAL``); a kept
    chunk's gradient summed over "model" (llama's ``KEEP`` leaves given
    the model dim's sum); the gated norm's ``model_sum`` dropped (zamba2);
    and of the sequence split: the norm scales' gradients not summed over
    "model" (llama's ``ln1``, ``ln2`` and ``final_norm`` roles None in
    place of ``PARTIAL``); an attention with no split leaf (heads3) that
    reduce-scatters its whole output instead of taking its rows; a rank
    that takes the rows of the next shard (heads3, ``SeqSplit.rows``).
    Every rank plants the same fault, so that the collectives still
    pair."""
    from repro_torch.models import attention, ssm
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as SH

    llama = ("llama3.2-3b", CELLS[0][1], "")
    mqa = ("llama3.2-3b", CELLS[0][1], "mqa")
    zamba = ("zamba2-7b", CELLS[0][1], "")
    heads3 = ("llama3.2-3b", CELLS[0][1], "heads3")
    real_roles, real_init = T.model_roles, SH.LayerShards.__init__
    real_leave, real_rows = attention.leave, SH.SeqSplit.rows

    def whole_kv(cfg, rules, mesh, shape=None):
        roles = real_roles(cfg, rules, mesh, shape)
        for k in ("wk", "wv"):
            roles["layers"]["attn"][k] = None
        return roles

    def norms_unsummed(cfg, rules, mesh, shape=None):
        roles = real_roles(cfg, rules, mesh, shape)
        for norm in (roles["layers"]["ln1"], roles["layers"]["ln2"],
                     roles["final_norm"]):
            norm["scale"] = None
        return roles

    def next_rows(self, t):
        return real_rows(dataclasses.replace(
            self, index=(self.index + 1) % self.count), t)

    def summed_chunks(self, *a, **k):
        real_init(self, *a, **k)
        self.sums = [(MODEL_DIM,) if r == SH.KEEP else s
                     for r, s in zip(self.roles, self.sums)]

    faults = {"leave_dropped": (attention, "leave",
                                lambda x, split=True: real_leave(x, False),
                                llama),
              "mqa_kv_sum_skipped": (T, "model_roles", whole_kv, mqa),
              "kept_chunk_summed": (SH.LayerShards, "__init__",
                                    summed_chunks, llama),
              "gated_norm_sum_dropped": (ssm, "model_sum", lambda x: x,
                                         zamba),
              "norm_sum_skipped": (T, "model_roles", norms_unsummed, llama),
              "unsplit_scattered": (
                  attention, "leave",
                  lambda x, split=True: real_leave(x, True), heads3),
              "next_shard_rows": (SH.SeqSplit, "rows", next_rows, heads3)}
    out = {}
    for name, (owner, attr, fault, cell) in faults.items():
        real = getattr(owner, attr)
        setattr(owner, attr, fault)
        try:
            out[name] = _planted_misses(cell, ref, mesh)
        finally:
            setattr(owner, attr, real)
    if not all(out.values()):
        _check([f"a planted fault passed: {out}"])
    return out


def _inner_plants(ref, mesh) -> dict:
    """Five faults planted in prefill's ``seq_inner``, each in a prefill
    cell whose logits or their layout must then miss (``_prefill_misses``;
    the number of failed checks, 1 where the step raised); in the heads3
    cell: B3's query offset dropped (every rank's queries masked as rows 0
    to S/model of the sequence); K and V left ungathered (each rank's own
    rows in their place in the sequence, the other ranks' zeros); the rows
    gathered over the sequence before the head, where the pruned spec
    keeps the logits split; in rwkv6-1.6b's, a whole-sequence block that
    keeps the next rank's rows of its output (``_own_rows``); in
    zamba2-7b's, a Mamba2 block that skips the gather of the sequence (its
    own rows in their place, the other ranks' zeros). Every rank plants
    the same fault, so that the collectives still pair."""
    from repro_torch.models import attention, ssm
    from repro_torch.models import layers as L
    from repro_torch.parallel import sharding as SH

    cell = ("llama3.2-3b", ("p", "prefill", 32, 4), "heads3")
    rwkv = ("rwkv6-1.6b", ("p", "prefill", 32, 4), "inner")
    zamba = ("zamba2-7b", ("p", "prefill", 32, 4), "inner")
    real_flash = attention.flash_attention
    real_own, real_enter = SH._own_rows, ssm.enter

    def no_offset(q, k, v, *, causal=True, window=0, q_offset=0):
        return real_flash(q, k, v, causal=causal, window=window)

    def ungathered(x):
        sp = SH.current_seq_split()
        n = x.shape[1]
        whole = x.new_zeros((x.shape[0], n * sp.count) + x.shape[2:])
        whole[:, sp.index * n:(sp.index + 1) * n] = x
        return whole

    def gathered_logits(cfg, p, x):
        w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
        return SH.enter(x, False) @ w

    def next_rows(x, sp):
        return real_own(x, dataclasses.replace(
            sp, index=(sp.index + 1) % sp.count))

    def mamba_ungathered(x, split=True, rows=None):
        return ungathered(x) if SH.current_seq_split() else \
            real_enter(x, split, rows)

    faults = {"offset_dropped": (attention, "flash_attention", no_offset,
                                 cell),
              "kv_ungathered": (attention, "seq_gather", ungathered, cell),
              "logits_gathered": (L, "lm_logits", gathered_logits, cell),
              "whole_block_next_rows": (SH, "_own_rows", next_rows, rwkv),
              "mamba_ungathered": (ssm, "enter", mamba_ungathered, zamba)}
    out = {}
    for name, (owner, attr, fault, where) in faults.items():
        real = getattr(owner, attr)
        setattr(owner, attr, fault)
        try:
            _, logits = _prefill_once(*where, ref, mesh)
            out[name] = len(_prefill_misses(*where, ref, mesh, logits))
        except (RuntimeError, ValueError):
            out[name] = 1
        finally:
            setattr(owner, attr, real)
    if not all(out.values()):
        _check([f"a planted seq_inner fault passed: {out}"])
    return out


def _planted_misses(cell: tuple, ref, mesh) -> int:
    """The failed checks of one train step of ``cell`` with a fault
    planted: its mismatches with the reference's, or 1 where the step
    raised (every rank plants the same fault, so every rank raises at the
    same point and no collective is left unpaired)."""
    from torch.utils.checkpoint import CheckpointError

    try:
        _, state, m = _train_once(*cell, ref, mesh)
    except (CheckpointError, RuntimeError):
        return 1
    return len(_train_mismatches(*cell, ref, state, m))


def _decode_plants(ref, mesh) -> dict:
    """Five faults planted in the serve step's split, each in a decode
    cell whose values must then miss the reference's (the number of failed
    checks: logits, greedy tokens and state leaves): a slot's new K/V row
    written into every rank's shard, not only the one that holds its
    global row (``attention._owned``); the shards' score maxima not
    combined, each shard exponentiating against its own (the combine
    without its rescale to the global max); the shard's rows read as
    local indices, for its writes and its mask (``attention._shard_rows``);
    at global batch 1, the combine over "model" alone, where the cache is
    split over "data" and "model" (``sharding.mesh_group``); the decode
    MLP's ``leave`` dropped. Every rank plants the same fault, so that the
    collectives still pair."""
    import torch.nn.functional as F

    from repro_torch.models import attention
    from repro_torch.models import layers as L
    from repro_torch.parallel import sharding as SH

    llama = ("llama3.2-3b", ("d", "decode", 64, 4), "")
    batch1 = ("llama3.2-3b", ("d", "decode", 64, 1), "batch1")
    real_reduce = SH._kv_reduce

    def own_max(group, x, op):
        return x.clone() if op == "max" else real_reduce(group, x, op)

    def mlp_kept_partial(cfg, p, x):
        x = SH.enter(x)
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]

    faults = {
        "row_written_on_every_shard": (
            attention, "_owned", lambda live, slot, rows: live, llama),
        "max_not_combined": (SH, "_kv_reduce", own_max, llama),
        "rows_read_as_local": (
            attention, "_shard_rows",
            lambda split, rows: (0, rows * split.count), llama),
        "batch1_over_model_alone": (
            SH, "mesh_group", lambda m, dims: m.get_group(MODEL_DIM), batch1),
        "mlp_leave_dropped": (L, "mlp_apply", mlp_kept_partial, llama)}
    out = {}
    for name, (owner, attr, fault, cell) in faults.items():
        real = getattr(owner, attr)
        setattr(owner, attr, fault)
        try:
            _, logits, state = _decode_once(*cell, ref, mesh)
        finally:
            setattr(owner, attr, real)
        out[name] = len(_decode_mismatches(*cell, ref, logits, state))
    if not all(out.values()):
        _check([f"a planted decode fault passed: {out}"])
    return out


@contextlib.contextmanager
def _backward_on_another_thread():
    """Each ``Tensor.backward`` run on a new thread, as the autograd engine
    runs a card's backward (and remat's recompute in it) on a device
    thread of its own, where what the forward's thread set up (its
    sharding context) is not set."""
    real = torch.Tensor.backward

    def backward(self, *a, **k):
        failed = []

        def run():
            try:
                real(self, *a, **k)
            except BaseException as e:  # re-raised on the caller's thread
                failed.append(e)
        t = threading.Thread(target=run)
        t.start()
        t.join()
        if failed:
            raise failed[0]

    torch.Tensor.backward = backward
    try:
        yield
    finally:
        torch.Tensor.backward = real


def _card_threads(ref, mesh) -> dict:
    """llama's and zamba2's train cells (remat full) with every backward
    on another thread: the values must match the reference's, since the
    recompute re-enters the forward's context (``sharding.in_context``);
    and must miss them without it (a planted fault: the recompute then
    runs ``enter``/``leave``/``model_sum`` as the identity, on rows that
    are not the forward's, which checkpoint refuses). The number of
    failed checks of each."""
    import contextlib as cl

    from repro_torch.models import transformer as T

    llama = ("llama3.2-3b", CELLS[0][1], "")
    zamba = ("zamba2-7b", CELLS[0][1], "")
    out = {}
    with _backward_on_another_thread():
        for cell in (llama, zamba):
            _, state, m = _train_once(*cell, ref, mesh)
            out[cell_key(*cell)] = len(_train_mismatches(*cell, ref, state,
                                                         m))
        real = T.in_context
        T.in_context = lambda context: cl.nullcontext()
        try:
            out["without_in_context"] = _planted_misses(llama, ref, mesh)
        finally:
            T.in_context = real
    if out["without_in_context"] == 0 or out[cell_key(*llama)] \
            or out[cell_key(*zamba)]:
        _check([f"a backward on another thread: {out}"])
    return out


def _lengths(ref, mesh) -> dict:
    """The ``LENGTHS`` prefills through ``build_prefill_step``'s function
    on batches split over "data" alone: their logits held to the
    reference's at 1e-5, with sequence collectives in both (the split
    stream's). Returns each one's ``MODEL`` counts."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.steps import build_prefill_step, place
    from repro_torch.parallel.layouts import rules_for
    from repro_torch.parallel.sharding import (MODEL, NamedSharding, full,
                                               use_mesh)

    out = {}
    for key, (s, t) in LENGTHS.items():
        cfg, _, _ = _config("seamless-m4t-medium", ("p", "prefill", 32, 4),
                            "")
        shape = ShapeSpec("p", "prefill", 32, 4)
        rules = rules_for(cfg, shape, mesh)
        prog = build_prefill_step(cfg, shape, mesh, rules)
        params = place(_torch(_tree(ref, key + "/params")),
                       prog.in_shardings[0])
        rows = NamedSharding(mesh, ("data",))
        batch = {k: place(v, rows) for k, v in
                 _torch(_tree(ref, key + "/batch")).items()}
        MODEL.reset()
        with use_mesh(mesh, rules):
            logits = full(prog.fn(params, batch))
        out[key] = MODEL.counts()
        bad = mismatches({"": logits.numpy()}, {"": ref[key + "/logits"]},
                         key + " logits")
        if not out[key]["all_gathers"]:
            bad.append(f"{key}: no sequence all-gather")
        _check(bad)
    return out


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
        gathers = {cell_key(*c): _cell(*c, ref, mesh) for c in CELLS}
        cases = _gather_cases(mesh)
        region_plants = _plants(ref, mesh)
        inner_plants = _inner_plants(ref, mesh)
        decode_plants = _decode_plants(ref, mesh)
        threads = _card_threads(ref, mesh)
        lengths = _lengths(ref, mesh)
        pipe = _pipeline(ref)
        every = [None] * RANKS
        dist.all_gather_object(every, gathers)
        # a parameter's shard on this rank: the state really is sharded
        cfg = reduced(get_config("llama3.2-3b"))
        shape = ShapeSpec(*CELLS[0][1])
        sh = build_train_step(cfg, shape, mesh, rules_for(cfg, shape, mesh)
                              ).in_shardings[0]["params"]["layers"]["attn"]
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump({"cells": [cell_key(*c) for c in CELLS],
                           "gathers": every, "gather_cases": cases,
                           "region_plants": region_plants,
                           "inner_plants": inner_plants,
                           "decode_plants": decode_plants,
                           "backward_threads": threads,
                           "pipeline": pipe, "lengths": lengths,
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
