"""The port's mesh step builders against the JAX package's on the CPU.

One process, a 1×1 ("data", "model") mesh in both packages (the port's
over a gloo group of one rank): ``build_train_step`` at ``accum`` 2 on the
reduced llama3.2-3b in f32, global batch 8 of 32 tokens, with AdamW, with
Adafactor (state from ``init_factored_state``) and with int8 gradient
compression; two steps from one carried state, the loss, the grad norm
(AdamW's) and every leaf of the state after each step. Then ``train(mesh=
...)`` from the same reference checkpoint, and ``build_prefill_step``'s and
``build_serve_step``'s outputs. Tolerance (``assert_tree_close``): every
element within 1e-5 of its leaf's max |value| (losses and the grad norm
1e-5 relative), bf16 leaves (Adafactor's first moment, the KV caches)
also within one bf16 ulp of each element, since an f32 difference far
below 1e-5 may round them apart; in the train states alone a share of
1e-3 of a leaf's elements (one at least) may lie within only 1e-2, where
the optimizers amplify f32 rounding (``mismatches`` says where).

Then the sharded world: ``tests/_torch_mesh_world.py`` in a subprocess
with its own timeout starts 4 gloo ranks on a (2, 2) mesh and runs the
five cells of the reference's ``tests/test_dryrun_small.py`` as programs,
and mixtral-8x7b, Adafactor, int8-compression, remat "none" and remat
"dots" llama3.2-3b train cells, rwkv6-1.6b and zamba2-7b train cells and
an MQA llama3.2-3b train cell (reduced configs in f32, ``accum`` 2 where
a cell trains), a llama3.2-3b train cell with 3 heads (which do not
divide the model size) and a llava-next-mistral-7b prefill, every train
and prefill cell splitting its residual stream along the sequence over
"model" (Megatron-SP), two llama3.2-3b prefills that keep the sequence
on "model" inside the blocks too (prefill's ``seq_inner``: 3 heads,
where the rules set it, and GQA under the rules' override; attention
over each rank's query rows against the all-gathered K/V, the MLP and
the head on the rows, the logits split along the sequence) and
seamless-m4t-medium, mixtral-8x7b, llava-next-mistral-7b, rwkv6-1.6b and
zamba2-7b prefills under the same override (RWKV's and Mamba2's layers
whole on every model rank over the gathered sequence), two
seamless-m4t-medium prefills whose frames
and tokens differ in length (one stream split, the other of odd length
whole), and four decode cells whose caches split along
their sequence (flash-decode: llama3.2-3b at batch 4 and 1, mixtral-8x7b's
ring, seamless-m4t-medium; seeded cache rows, the reference run on the
same state), against the reference's 1×1 results computed here, with
the layer gather's memory, gradient buffers and collectives held on
every rank, the model-parallel region's flops (``FlopCounterMode``,
against the same rows on one device), all-reduces, sequence all-gathers
and reduce-scatters with their bytes, and the block inputs remat holds
(llama's 1/2 of the unsplit path's) held to the code's count, a serve
step's split held (no state leaf gathered but Mamba2's
conv, a cache's storage 1/4, the model and combine all-reduces the
code's count, greedy tokens equal), a unit's gather held against the
whole path with three planted faults that must fail, seven planted
faults of the model-parallel region and its sequence split, five of
``seq_inner`` and five of the serve step's split that must fail, and ``pipeline_apply`` on a 4-rank "stage" mesh against
the reference's sequential forward and ``jax.grad``. A rank's failure
fails the test. Beside the world, the dry run (``tests/_torch_dryrun_world.py
gloo``: ``repro_torch.launch.dryrun`` on a fake (2, 2) world, each rank)
must issue the collectives each gloo rank issued in ``ISSUED_CELLS``:
kind, result bytes, group size and count.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import ShapeSpec as RShapeSpec
from repro.launch import mesh as RMESH
from repro.launch import steps as RS
from repro.launch import train as RT
from repro.models import inputs as RI
from repro.models import transformer as RTF
from repro.optim.adafactor import init_factored_state as ref_factored
from repro.parallel.layouts import rules_for as ref_rules_for
from repro.parallel.sharding import use_mesh as ref_use_mesh
from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps as S
from repro_torch.launch import train as T
from repro_torch.models.weights import state_to_numpy, \
    train_state_from_reference
from repro_torch.parallel.layouts import rules_for
from repro_torch.parallel.sharding import full, use_mesh

from _torch_mesh_world import CELLS, ISSUED_CELLS, LENGTHS, POSITIONS, \
    TRAIN_OUTLIERS, VARIANTS, Spy, cell_key, decode_tokens, flat, \
    mismatches, seeded_state

ROOT = Path(__file__).resolve().parent.parent
ARCH = "llama3.2-3b"
TRAIN = ("t", "train", 32, 8)
WORLD_TIMEOUT_S = 300


@pytest.fixture
def mesh():
    m = MESH.make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    yield m
    MESH.release_process_group()


def _ref_mesh():
    return RMESH.make_mesh_compat((1, 1), ("data", "model"))


def _cfgs(arch=ARCH, **kw):
    kw = dict(dtype="float32", **kw)
    return (dataclasses.replace(ref_reduced(ref_get_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def _np(tree):
    return jax.tree.map(np.array, tree)


def _port(tree):
    """Numpy leaves (bf16 as ml_dtypes) as CPU tensors."""
    return jax.tree.map(lambda a: torch.from_numpy(
        np.asarray(a).view(np.int16)).view(torch.bfloat16)
        if np.asarray(a).dtype == ml_dtypes.bfloat16
        else torch.from_numpy(np.array(a)), tree)


def assert_tree_close(port, ref, what, outliers=0.0):
    """``_torch_mesh_world.mismatches``' tolerance, leaf by leaf; a train
    state's with ``outliers=TRAIN_OUTLIERS``."""
    bad = mismatches(flat(port), flat(ref), what, outliers)
    assert not bad, bad


def _ref_train_state(rcfg, compress):
    st = RS.init_train_state(rcfg, jax.random.PRNGKey(0),
                             compress_grads=compress)
    if rcfg.optimizer == "adafactor":
        st["opt"] = ref_factored(st["params"])
    return st


def _batches(rcfg, shape, n):
    return [_np(RI.synthetic_batch(rcfg, shape, seed=i)) for i in range(n)]


@pytest.mark.parametrize("variant", ["adafactor", "adamw", "compress"])
def test_train_step_matches_reference_on_a_1x1_mesh(variant, mesh):
    kw, compress = VARIANTS["" if variant == "adamw" else variant]
    rcfg, cfg = _cfgs(accum=2, **kw)
    rshape, shape = RShapeSpec(*TRAIN), ShapeSpec(*TRAIN)
    batches = _batches(rcfg, rshape, 2)

    rmesh = _ref_mesh()
    rrules = ref_rules_for(rcfg, rshape, rmesh)
    rstate = _ref_train_state(rcfg, compress)
    init = _np(rstate)
    rstep = RS.build_train_step(rcfg, rshape, rmesh, rrules,
                                compress_grads=compress).jitted()
    rules = rules_for(cfg, shape, mesh)
    prog = S.build_train_step(cfg, shape, mesh, rules,
                              compress_grads=compress)
    state = train_state_from_reference(cfg, init, "cpu",
                                       shardings=prog.in_shardings[0])
    step = prog.jitted()
    for i, b in enumerate(batches):
        with ref_use_mesh(rmesh, rrules):
            rstate, rm = rstep(rstate, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        with use_mesh(mesh, rules):
            state, m = step(state, _port(b))
        assert set(m) == set(rm), (set(m), set(rm))
        for k in ("loss", "ce_loss", "grad_norm"):
            if k in rm:
                assert float(m[k]) == pytest.approx(float(rm[k]), rel=1e-5)
        assert float(m["moe_aux"]) == float(rm["moe_aux"]) == 0.0
        assert_tree_close(state_to_numpy(state), _np(rstate),
                          f"{variant} step {i}", TRAIN_OUTLIERS)


def test_train_state_layouts_follow_the_reference(mesh):
    """Adafactor's vr/vc drop the last and second-to-last dim of each
    parameter's spec; ef takes the parameters' layouts; counts replicate."""
    rcfg, cfg = _cfgs(optimizer="adafactor")
    rshape, shape = RShapeSpec(*TRAIN), ShapeSpec(*TRAIN)
    rmesh = _ref_mesh()
    rprog = RS.build_train_step(rcfg, rshape, rmesh,
                                ref_rules_for(rcfg, rshape, rmesh),
                                compress_grads=True)
    prog = S.build_train_step(cfg, shape, mesh, rules_for(cfg, shape, mesh),
                              compress_grads=True)
    ref_specs = jax.tree.map(lambda s: tuple(s.spec), rprog.in_shardings[0])
    specs = jax.tree.map(lambda s: s.spec, prog.in_shardings[0],
                         is_leaf=lambda s: isinstance(s, S.NamedSharding))
    assert specs == ref_specs
    meta = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)),
                        prog.args[0])
    ref_meta = jax.tree.map(lambda t: (tuple(t.shape), f"torch.{t.dtype}"),
                            rprog.args[0])
    assert meta == ref_meta
    # lowering runs on fake tensors in a fake world only (the dry run),
    # never in this gloo group
    with pytest.raises(RuntimeError, match="fake world"):
        prog.lower()


def test_train_on_a_mesh_matches_reference(tmp_path, monkeypatch, mesh):
    """Both trainers resume from the reference's init_train_state (f32),
    saved by the reference's Checkpointer at step 0, on a 1×1 mesh."""
    def f32(cfg, _red=ref_reduced):
        return dataclasses.replace(_red(cfg), dtype="float32")

    monkeypatch.setattr(RT, "reduce_cfg", f32)
    monkeypatch.setattr(T, "reduce_cfg", lambda c: dataclasses.replace(
        reduced(c), dtype="float32"))
    rcfg, _ = _cfgs()
    state = RS.init_train_state(rcfg, jax.random.PRNGKey(0))
    for name in ("ref", "port"):
        RefCheckpointer(str(tmp_path / name)).save(0, state, blocking=True)
    kw = dict(steps=3, log_every=0, global_batch=8, seq_len=32)
    ref = RT.train(ARCH, checkpoint_dir=str(tmp_path / "ref"),
                   mesh=_ref_mesh(), **kw)
    port = T.train(ARCH, checkpoint_dir=str(tmp_path / "port"), mesh=mesh,
                   **kw)
    assert port["steps"] == ref["steps"] == 3
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)
    # the final checkpoints hold the same state, in the same format
    restored = {n: RefCheckpointer(str(tmp_path / n)).restore(3, state)
                for n in ("ref", "port")}
    assert_tree_close(_np(restored["port"]), _np(restored["ref"]), "ckpt",
                      TRAIN_OUTLIERS)


def test_prefill_and_serve_steps_match_reference(mesh):
    rcfg, cfg = _cfgs()
    params = _np(RTF.init_params(rcfg, jax.random.PRNGKey(0)))
    rmesh = _ref_mesh()

    pre = ("p", "prefill", 32, 4)
    rshape, shape = RShapeSpec(*pre), ShapeSpec(*pre)
    batch = _np(RI.synthetic_batch(rcfg, rshape, seed=3))
    rrules = ref_rules_for(rcfg, rshape, rmesh)
    with ref_use_mesh(rmesh, rrules):
        rlogits = RS.build_prefill_step(rcfg, rshape, rmesh, rrules).jitted()(
            params, batch)
    rules = rules_for(cfg, shape, mesh)
    with use_mesh(mesh, rules):
        logits = S.build_prefill_step(cfg, shape, mesh, rules).jitted()(
            params, _port(batch))
    assert_tree_close([full(logits).numpy()], [np.asarray(rlogits)],
                      "prefill logits")

    dec = ("d", "decode", 32, 4)
    rshape, shape = RShapeSpec(*dec), ShapeSpec(*dec)
    rrules = ref_rules_for(rcfg, rshape, rmesh)
    rules = rules_for(cfg, shape, mesh)
    rstate = RTF.init_decode_state(rcfg, 4, 32)
    rprog = RS.build_serve_step(rcfg, rshape, rmesh, rrules)
    prog = S.build_serve_step(cfg, shape, mesh, rules)
    assert prog.donate_argnums == rprog.donate_argnums == (1,)
    rstep, step = rprog.jitted(), prog.jitted()
    state = _port(_np(rstate))
    for t in range(3):
        tokens = np.arange(4, dtype=np.int32) * 37 + 11 * t
        with ref_use_mesh(rmesh, rrules):
            rlogits, rstate = rstep(params, rstate, jnp.asarray(tokens))
        with use_mesh(mesh, rules):
            logits, state = step(params, state, torch.from_numpy(tokens))
        assert_tree_close([full(logits).numpy()], [np.asarray(rlogits)],
                          f"decode logits {t}")
    assert_tree_close(state_to_numpy(state), _np(rstate), "decode state")


def test_no_dtensor_reaches_a_kernel_entry_point(mesh, monkeypatch):
    """The mesh steps hand B2 and B3 (whose CUDA wrappers read
    ``data_ptr()``) plain local tensors, never a DTensor."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import attention as attn
    from repro_torch.models import layers as ML

    calls = []

    def spy(fn):
        def wrapped(*args, **kwargs):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            assert tensors and not any(isinstance(a, DTensor)
                                       for a in tensors)
            calls.append(fn)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(ML, "_rms_norm_op", spy(ML._rms_norm_op))
    monkeypatch.setattr(attn, "flash_attention", spy(attn.flash_attention))
    rcfg, cfg = _cfgs(accum=2)
    shape = ShapeSpec(*TRAIN)
    rules = rules_for(cfg, shape, mesh)
    prog = S.build_train_step(cfg, shape, mesh, rules)
    state = train_state_from_reference(cfg, _np(_ref_train_state(rcfg,
                                                                 False)),
                                       "cpu", shardings=prog.in_shardings[0])
    batch = _port(_batches(rcfg, RShapeSpec(*TRAIN), 1)[0])
    with use_mesh(mesh, rules):
        prog.jitted()(state, batch)
        S.build_prefill_step(cfg, shape, mesh, rules).jitted()(
            state["params"], {"tokens": batch["tokens"]})
    n = cfg.num_layers
    # two microbatches of 2n+1 norms and n attentions, recomputed but for
    # the final norm; then the prefill's
    assert len(calls) == 2 * (4 * n + 1 + 2 * n) + (2 * n + 1 + n)


def test_the_1x1_gather_copies_nothing(mesh):
    """On a mesh of one rank every shard is the whole: a train step's
    gathers return the state's own storage (no byte copied, no
    collective), once a unit in the forward and once in remat full's
    recompute, and once the rest, a microbatch; the gradients accumulate
    into buffers of the parameters' own shapes."""
    from repro_torch._tree import leaves
    from repro_torch.parallel.sharding import GATHER, MODEL, local

    rcfg, cfg = _cfgs(accum=2)
    shape = ShapeSpec(*TRAIN)
    rules = rules_for(cfg, shape, mesh)
    prog = S.build_train_step(cfg, shape, mesh, rules)
    state = train_state_from_reference(cfg, _np(_ref_train_state(rcfg,
                                                                 False)),
                                       "cpu", shardings=prog.in_shardings[0])
    batch = _port(_batches(rcfg, RShapeSpec(*TRAIN), 1)[0])
    with Spy() as spy, use_mesh(mesh, rules):
        prog.jitted()(state, batch)
    n = cfg.num_layers
    assert GATHER.counts() == {"calls": 2 * (1 + 2 * n), "bytes_copied": 0,
                               "all_gathers": 0, "reductions": 0,
                               "reduce_scatters": 0, "all_reduces": 0}
    # a model axis of one rank opens no model-parallel region: no
    # all-reduce, and no all-gather or reduce-scatter of the sequence
    none = {"all_reduces": 0, "bytes": 0, "all_gathers": 0,
            "gathered_bytes": 0, "reduce_scatters": 0, "scattered_bytes": 0}
    assert spy.region == none
    with use_mesh(mesh, rules):
        S.build_prefill_step(cfg, shape, mesh, rules).jitted()(
            state["params"], {"tokens": batch["tokens"]})
    assert MODEL.counts() == none  # the train step's and the prefill's
    assert GATHER.calls == 2 * (1 + 2 * n) + 1 + n
    assert GATHER.bytes_copied == 0 and spy.peak == 0
    grads = leaves(spy.grads)
    assert [g.shape for g in grads] == [local(p).shape
                                        for p in leaves(state["params"])]
    storage = {g.untyped_storage().data_ptr() for g in grads}
    model = spy.model
    for unit in [model.rest] + [u for us in model.units.values() for u in us]:
        assert unit.gather() is unit.tree  # the state's own storage
        assert all(s.grad.untyped_storage().data_ptr() in storage
                   and s.untyped_storage().data_ptr()
                   in {local(p).untyped_storage().data_ptr()
                       for p in leaves(state["params"])}
                   for s in unit.parts)


@pytest.mark.parametrize("arch", [ARCH, "zamba2-7b"])
def test_the_1x1_step_computes_the_one_device_flops(arch, mesh):
    """The world's yardstick for the model split's flops
    (``_torch_mesh_world.one_device_flops``: the same rows' forward and
    backward on one device) is what a train step on a 1x1 mesh computes,
    flop for flop (``FlopCounterMode``), and on such a mesh every leaf is
    whole (``model_roles`` all None)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch._tree import leaves
    from repro_torch.models.transformer import model_roles

    from _torch_mesh_world import one_device_flops

    rcfg, cfg = _cfgs(arch, accum=2)
    shape = ShapeSpec(*TRAIN)
    rules = rules_for(cfg, shape, mesh)
    assert not any(leaves(model_roles(cfg, rules, mesh)))
    prog = S.build_train_step(cfg, shape, mesh, rules)
    init = _np(_ref_train_state(rcfg, False))
    state = train_state_from_reference(cfg, init, "cpu",
                                       shardings=prog.in_shardings[0])
    batch = _port(_batches(rcfg, RShapeSpec(*TRAIN), 1)[0])
    with use_mesh(mesh, rules), FlopCounterMode(display=False) as fc:
        prog.jitted()(state, batch)
    whole = one_device_flops(cfg, shape, _port(init)["params"], batch, mesh)
    assert fc.get_total_flops() == whole > 0


def test_remat_recomputes_in_the_forward_context():
    """Remat's recompute runs in the backward, which a card runs on the
    autograd engine's own thread: the recomputed block still sees the
    context its forward ran in (here the data-parallel split), with the
    backward run on another thread as a card would run it."""
    import threading
    import types

    from repro_torch.models.transformer import _maybe_remat
    from repro_torch.parallel.sharding import batch_shards, data_parallel

    seen = []

    def block(x):
        seen.append(batch_shards())
        return torch.tanh(x) * 2

    x = torch.ones(3, requires_grad=True)
    stub = types.SimpleNamespace(size=lambda k: 2)
    with data_parallel(stub, (0,)):
        y = _maybe_remat(block, "full")(x).sum()
    t = threading.Thread(target=y.backward)
    t.start()
    t.join()
    assert seen == [2, 2] and x.grad is not None


def test_a_rebuilt_tree_holds_its_leaves_no_longer_than_the_caller():
    """``unflatten_like`` (which the layer gather builds its output with)
    leaves no reference cycle behind: a gathered leaf dies when its last
    holder lets it go, not when the cyclic collector runs."""
    import gc
    import weakref

    from repro_torch._tree import unflatten_like

    gc.disable()
    try:
        values = (torch.ones(2), torch.ones(3))
        refs = [weakref.ref(v) for v in values]
        tree = unflatten_like({"a": [0], "b": 0}, values)
        assert tree["a"][0] is values[0] and tree["b"] is values[1]
        del values, tree
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_shard_act_lays_out_a_dtensor(mesh, monkeypatch):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.parallel.sharding import (
        NamedSharding, ShardingRules, distribute, shard_act)

    x = distribute(torch.ones(4, 8, 16), NamedSharding(mesh, ()))
    calls = []
    real = DTensor.redistribute
    monkeypatch.setattr(DTensor, "redistribute", lambda self, *a, **k: (
        calls.append(a), real(self, *a, **k))[1])
    with use_mesh(mesh, ShardingRules(light=True)):
        assert shard_act(x, ("batch", "seq", "embed")) is x and not calls
        y = shard_act(x, ("batch", "seq", "embed"), essential=True)
    assert len(calls) == 1  # the essential constraint is still applied
    assert tuple(y.placements) == (Shard(0), Replicate())


# ---------------------------------------------------------------------------
# The sharded world: 4 gloo ranks on a (2, 2) mesh
# ---------------------------------------------------------------------------

def _ref_cell(arch, cell, variant, out: dict) -> None:
    """The reference's 1×1 result of one cell, into ``out`` (npz keys)."""
    rshape = RShapeSpec(*cell)
    kw, compress = VARIANTS[variant]
    rcfg, _ = _cfgs(arch, accum=2 if rshape.kind == "train" else 1, **kw)
    rmesh = _ref_mesh()
    rules = ref_rules_for(rcfg, rshape, rmesh)
    prog = (RS.build_train_step(rcfg, rshape, rmesh, rules,
                                compress_grads=compress)
            if rshape.kind == "train"
            else RS.build_cell_program(rcfg, rshape, rmesh, rules))
    key = cell_key(arch, cell, variant)

    def put(name, tree):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            a = np.array(leaf)
            if a.dtype == ml_dtypes.bfloat16:
                a = a.view(np.uint16)
            out[f"{key}/{name}{jax.tree_util.keystr(path)}"] = a

    if rshape.kind == "train":
        state = _ref_train_state(rcfg, compress)
        batch = _np(RI.synthetic_batch(rcfg, rshape, seed=0))
        put("in_state", _np(state))
        put("batch", batch)
        with ref_use_mesh(rmesh, rules):
            state, m = prog.jitted()(state, batch)
        put("out_state", _np(state))
        put("metrics", dict(m))
        return
    params = _np(RTF.init_params(rcfg, jax.random.PRNGKey(0)))
    put("params", params)
    if rshape.kind == "prefill":
        batch = _np(RI.synthetic_batch(rcfg, rshape, seed=0))
        put("batch", batch)
        with ref_use_mesh(rmesh, rules):
            put("logits", prog.jitted()(params, batch))
        return
    state = RTF.init_decode_state(rcfg, rshape.global_batch, rshape.seq_len)
    if key in POSITIONS:
        state = jax.tree.map(jnp.asarray,
                             seeded_state(_np(state), POSITIONS[key]))
    put("in_state", _np(state))
    step = prog.jitted()
    for t in range(3):
        tokens = decode_tokens(rshape.global_batch, t)
        with ref_use_mesh(rmesh, rules):
            logits, state = step(params, state, jnp.asarray(tokens))
        put(f"logits{t}", logits)
    put("out_state", _np(state))


def _ref_lengths(out: dict) -> None:
    """The reference's 1×1 forward of each ``LENGTHS`` prefill: seamless's
    reduced f32 config on 4 rows of tokens and frames of other lengths."""
    rcfg, _ = _cfgs("seamless-m4t-medium")
    params = _np(RTF.init_params(rcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    for key, (s, t) in LENGTHS.items():
        batch = {"tokens": rng.integers(0, rcfg.vocab_size, (4, s),
                                        dtype=np.int32),
                 "frames": rng.standard_normal((4, t, rcfg.d_model),
                                               dtype=np.float32)}
        logits, _ = RTF.forward(rcfg, params, batch)
        for name, tree in (("params", params), ("batch", batch)):
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
                out[f"{key}/{name}{jax.tree_util.keystr(path)}"] = \
                    np.array(leaf)
        out[f"{key}/logits"] = np.array(logits)


def _ref_pipeline(out: dict) -> None:
    """tests/test_pipeline.py's case: S 4, M 8, mb 2, d 16, tanh(x @ w);
    the sequential forward and its jax.grad."""
    S_, M, mb, d = 4, 8, 2, 16
    w = jax.random.normal(jax.random.PRNGKey(0), (S_, d, d)) * 0.3
    xs = jax.random.normal(jax.random.PRNGKey(1), (M, mb, d))

    def sequential(w, xs):
        def layer(x, wi):
            return jnp.tanh(x @ wi), None
        y, _ = jax.lax.scan(layer, xs.reshape(M * mb, d), w)
        return y.reshape(M, mb, d)

    out["pipeline/w"] = np.array(w)
    out["pipeline/xs"] = np.array(xs)
    out["pipeline/out"] = np.array(sequential(w, xs))
    out["pipeline/grad"] = np.array(jax.grad(
        lambda w: jnp.sum(jnp.square(sequential(w, xs))))(w))


def test_cells_and_pipeline_on_a_4_rank_world(tmp_path):
    ref: dict = {}
    for arch, cell, variant in CELLS:
        _ref_cell(arch, cell, variant, ref)
    _ref_lengths(ref)
    _ref_pipeline(ref)
    np.savez(tmp_path / "ref.npz", **ref)
    # the ranks talk over the loopback interface, whatever the host's
    # name resolves to
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    # the dry run of ISSUED_CELLS at each rank of a fake (2, 2) world, in a
    # process of its own beside the world's
    dry = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dryrun_world.py"),
         "gloo", str(tmp_path / "dry.json")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        proc = subprocess.run(
            [sys.executable, str(ROOT / "tests" / "_torch_mesh_world.py"),
             str(tmp_path / "ref.npz"), str(tmp_path / "out.json")],
            capture_output=True, text=True, env=env, timeout=WORLD_TIMEOUT_S)
        _, dry_err = dry.communicate(timeout=WORLD_TIMEOUT_S)
    finally:
        dry.kill()
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert dry.returncode == 0, dry_err[-4000:]
    res = json.loads((tmp_path / "out.json").read_text())
    # the dry run issues each rank's collectives as the gloo world did,
    # (kind, result bytes, group size) and how many: a serve step's three
    # steps three times one
    dry_res = json.loads((tmp_path / "dry.json").read_text())
    assert sorted(dry_res) == sorted(cell_key(*c) for c in ISSUED_CELLS)
    for name, ranks in dry_res.items():
        steps = 3 if "/decode" in name else 1
        for r, got in ranks.items():
            assert got["status"] == "ok", (name, r, got)
            want = res["gathers"][int(r)][name]["issued"]
            assert want and [[k, b, n, steps * c] for k, b, n, c in
                             got["collectives"]["issued"]] == want, \
                (name, r, got["collectives"]["issued"], want)
    assert res["cells"] == [cell_key(*c) for c in CELLS]
    assert res["pipeline"]["fwd_err"] < 1e-5
    assert res["pipeline"]["bwd_err"] < 1e-4
    assert res["world"] == {"ranks": 4, "mesh": {"data": 2, "model": 2}}
    # an enc-dec prefill's streams split by their own lengths (held there)
    assert sorted(res["lengths"]) == sorted(LENGTHS)
    # the state really was sharded over both axes
    assert res["wq_spec"] == [None, "data", "model", None]
    # every rank's gathers, held there (_held_gathers), as reported: at
    # most the rest and one unit alive at once (remat none keeps every
    # layer), gradient buffers of the local shards' bytes
    assert len(res["gathers"]) == 4
    for rank in res["gathers"]:
        assert sorted(rank) == sorted(res["cells"])
        for name, g in rank.items():
            held = g["peak_gathered_bytes"] <= g["bound_bytes"]
            assert held == (g["remat"] != "none"), (name, g)
            assert g["counts"]["calls"] > 0 and g["counts"]["all_gathers"] > 0
            assert g.get("grad_bytes") == g.get("local_param_bytes"), name
    # the model axis splits the arithmetic (each rank's flops against the
    # same rows on one device, and the model group's all-reduces, held on
    # every rank to the code's count): llama's matmuls all split, the other
    # cells' but for those every model rank computes whole; the serve step
    # splits the caches along their sequence (flash-decode), the MLP, the
    # experts, the vocab and the RWKV and SSM heads, and gathers no state
    # leaf but Mamba2's conv (held on every rank, _held_decode)
    halves = {"llama3.2-3b/train", "llama3.2-3b/train/adafactor",
              "llama3.2-3b/train/compress", "llama3.2-3b/prefill/heads3",
              "llama3.2-3b/prefill/seq_inner"}
    # prefill's seq_inner: attention, the MLP and the head on this rank's
    # rows, whole leaves; the rules set it for 3 heads on 2 model ranks,
    # an override for the others
    inner = {"llama3.2-3b/prefill/heads3", "llama3.2-3b/prefill/seq_inner",
             "seamless-m4t-medium/prefill/inner",
             "mixtral-8x7b/prefill/inner",
             "llava-next-mistral-7b/prefill/inner",
             "rwkv6-1.6b/prefill/inner", "zamba2-7b/prefill/inner"}
    # of which RWKV's and Mamba2's layers are whole on every model rank,
    # over the gathered sequence
    whole_layers = {"rwkv6-1.6b/prefill/inner", "zamba2-7b/prefill/inner"}
    decode = {cell_key(*c) for c in CELLS if c[1][1] == "decode"}
    for rank in res["gathers"]:
        for name, g in rank.items():
            if name in decode:
                assert g["model_all_reduces"] == \
                    g["model_all_reduces_code"] > 0, (name, g)
                caches = g["cache_local_fraction"]
                if name == "rwkv6-1.6b/decode":
                    assert not caches and not g["kv_seq_axes"], (name, g)
                else:  # 1/4: the batch over "data", the sequence "model"
                    assert set(caches.values()) == {0.25}, (name, g)
                    assert g["kv_seq_axes"] == (
                        ["data", "model"] if name.endswith("/batch1")
                        else ["model"]), (name, g)
                assert g["gathered_state"] == (
                    ["mamba/conv"] if name == "zamba2-7b/decode" else []), \
                    (name, g)
                continue
            assert g["flop_ratio"] == g["flop_ratio_code"], (name, g)
            if name == "llama3.2-3b/train/heads3":  # attention whole
                assert 0.5 < g["flop_ratio"] < 0.7, (name, g)
            elif name in whole_layers:  # the head on the rows alone splits
                assert 0.5 < g["flop_ratio"] < 1, (name, g)
            else:
                assert g["flop_ratio"] < 0.55, (name, g)
            if name in halves:
                assert g["flop_ratio"] == 0.5, (name, g)
            assert g["model_all_reduces"] == g["model_all_reduces_code"]
            # every train and prefill cell splits its residual stream along
            # the sequence (Megatron-SP): the all-gathers and
            # reduce-scatters, and their bytes, the code's count
            assert g["seq"] == g["seq_code"], (name, g)
            assert g.get("inner", False) == (name in inner), (name, g)
            if name in inner:
                # llama: K's and V's all-gathers a layer and nothing more,
                # no enter/leave around attention or the MLP (elsewhere
                # MoE's split experts and a split table's lookup scatter,
                # as the code counts); none before the head, whose logits
                # stay the rows' (Shard(1) on "model")
                if name.startswith("llama3.2-3b"):
                    assert g["seq"]["all_gathers"] == 2 * 2, (name, g)
                    assert g["seq"]["reduce_scatters"] == 0, (name, g)
                assert g["logits_split_dims"] == [0, 1], (name, g)
            else:
                assert min(g["seq"].values()) > 0, (name, g)
            if name.startswith("llama3.2-3b/train") and g["remat"] != "none":
                # remat holds this rank's rows of each block input: 1/2
                assert g["saved_bytes"] == g["saved_bytes_code"] \
                    == g["saved_bytes_unsplit"] // 2 > 0, (name, g)
            # only rwkv6's state misses the reference, where its unsplit
            # step misses it too (AdamW flips at gradients below its eps)
            assert "misses_as_unsplit" not in g or \
                name == "rwkv6-1.6b/train", (name, g)
    assert set(res["region_plants"]) == {
        "leave_dropped", "mqa_kv_sum_skipped", "kept_chunk_summed",
        "gated_norm_sum_dropped", "norm_sum_skipped", "unsplit_scattered",
        "next_shard_rows"}
    assert all(n > 0 for n in res["region_plants"].values()), \
        res["region_plants"]
    assert set(res["inner_plants"]) == {
        "offset_dropped", "kv_ungathered", "logits_gathered",
        "whole_block_next_rows", "mamba_ungathered"}
    assert all(n > 0 for n in res["inner_plants"].values()), \
        res["inner_plants"]
    assert set(res["decode_plants"]) == {
        "row_written_on_every_shard", "max_not_combined",
        "rows_read_as_local", "batch1_over_model_alone", "mlp_leave_dropped"}
    assert all(n > 0 for n in res["decode_plants"].values()), \
        res["decode_plants"]
    # a card runs the backward, and remat's recompute, on a thread of its
    # own: with each backward on another thread the values still match,
    # and miss without the recompute's re-entered context
    assert res["backward_threads"] == {
        "llama3.2-3b/train": 0, "zamba2-7b/train": 0,
        "without_in_context": res["backward_threads"]["without_in_context"]}
    assert res["backward_threads"]["without_in_context"] > 0
    cases = res["gather_cases"]
    assert cases["err"] <= 1e-6 and cases["alive_after_block"] == 0
    assert cases["plants"]["sum_over_model"] > 1e-6
    assert cases["plants"]["no_sum_over_data"] > 1e-6
    assert cases["plants"]["kept_alive_bytes"] > 0
