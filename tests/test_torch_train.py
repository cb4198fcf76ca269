"""The port's training path against the JAX package on the CPU: the loss,
every parameter's gradient, B2's and B3's plain backwards, remat, the
train state carried both ways, and ``train()`` end to end from the same
reference checkpoint.

Inputs are built in the reference (``init_params``/``init_train_state``,
its ``Checkpointer``) and handed over as numpy; batches come from
``SyntheticLMStream``, byte-identical in both packages. Tolerances:
cross-entropy within 1e-6 relative, ``forward_loss`` within 1e-5
relative, each gradient leaf within 1e-4 of the leaf's max |g| (f32; the
two packages sum in other orders); B2's and B3's backward in f32 within
1e-5 and 1e-4 of each gradient's max |·|, B2's bf16 dx within one bf16
ulp; the end-to-end bf16 losses within 1e-2 relative a step (bf16 rounds
at other places in XLA and PyTorch; the first step's is far tighter and is
held to 1e-3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import models as RM
from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.kernels.flash_attention.ref import attention_ref as ref_attention
from repro.kernels.rmsnorm.ref import rms_norm_ref as ref_rms_norm
from repro.launch import steps as RS
from repro.launch import train as RT
from repro.models import layers as RL
from repro_torch import models as M
from repro_torch._tree import leaves
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.data import SyntheticLMStream, device_put_batch
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_backward_cuda, flash_attention_cuda)
from repro_torch.kernels.flash_attention.ops import (
    FlashAttentionFn, flash_attention, flash_attention_backward)
from repro_torch.kernels.rmsnorm.kernel import rms_norm_backward_cuda
from repro_torch.kernels.rmsnorm.ops import RmsNormFn, rms_norm
from repro_torch.kernels.flash_attention import ops as ops_mod
from repro_torch.launch import train as T
from repro_torch.models import layers as L
from repro_torch.models import transformer as MT
from repro_torch.models.weights import state_to_numpy, \
    train_state_from_reference

ARCH = "llama3.2-3b"
SEQ = 32


def _cfgs(dtype="float32"):
    return (dataclasses.replace(ref_reduced(ref_get_config(ARCH)),
                                dtype=dtype),
            dataclasses.replace(reduced(get_config(ARCH)), dtype=dtype))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(arr):
    """numpy array -> its bytes, bf16 (ml_dtypes or uint16 view) alike."""
    return np.asarray(arr).tobytes()


@functools.lru_cache(maxsize=None)
def _ref_state(dtype="float32"):
    rcfg, _ = _cfgs(dtype)
    return _np(RS.init_train_state(rcfg, jax.random.PRNGKey(0)))


def _batch(cfg, seed=0, step=0):
    stream = SyntheticLMStream(cfg, ShapeSpec("t", "train", SEQ, 2))
    return stream.batch_at(step)


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 16, 96)) * 4).astype(np.float32)
    labels = rng.integers(0, 90, (2, 16)).astype(np.int32)
    mask = (rng.uniform(size=(2, 16)) > 0.3).astype(np.float32) \
        if masked else None
    ref = float(RL.cross_entropy_loss(jnp.asarray(logits),
                                      jnp.asarray(labels),
                                      None if mask is None else
                                      jnp.asarray(mask)))
    out = float(L.cross_entropy_loss(torch.from_numpy(logits),
                                     torch.from_numpy(labels),
                                     None if mask is None else
                                     torch.from_numpy(mask)))
    assert out == pytest.approx(ref, rel=1e-6)


def test_masked_positions_do_not_move_the_loss():
    _, cfg = _cfgs()
    model = M.params_from_reference(cfg, _ref_state()["params"], "cpu")
    b = device_put_batch(_batch(cfg), "cpu")
    mask = b["loss_mask"].clone()
    mask[:, :8] = 0
    l1, _ = MT.forward_loss(cfg, model, dict(b, loss_mask=mask),
                            remat="none")
    bad = b["labels"].clone()
    bad[:, :8] = 0
    l2, _ = MT.forward_loss(cfg, model, dict(b, labels=bad, loss_mask=mask),
                            remat="none")
    assert float(l1) == pytest.approx(float(l2), rel=1e-6)


def _port_loss_and_grads(cfg, params_np, batch, remat):
    state = train_state_from_reference(
        cfg, {"params": params_np, "opt": {"m": params_np, "v": params_np,
                                           "count": np.int32(0)},
              "step": np.int32(0)}, "cpu")
    model = MT.TransformerLM.from_stacked(cfg, state["params"])
    grads = MT.bind_stacked_grads(model, state["params"])
    loss, metrics = MT.forward_loss(cfg, model, device_put_batch(batch,
                                                                 "cpu"),
                                    remat=remat)
    loss.backward()
    return float(loss.detach()), metrics, grads


def test_forward_loss_and_every_gradient_match_jax_grad():
    rcfg, cfg = _cfgs()
    params = _ref_state()["params"]
    batch = _batch(cfg)

    def loss_fn(p):
        return RM.forward_loss(rcfg, p, jax.tree.map(jnp.asarray, batch),
                               remat="none")

    (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(jax.tree.map(jnp.asarray, params))
    loss, metrics, grads = _port_loss_and_grads(cfg, params, batch, "none")
    assert loss == pytest.approx(float(ref_loss), rel=1e-5)
    assert float(metrics["ce_loss"]) == pytest.approx(
        float(ref_metrics["ce_loss"]), rel=1e-5)
    flat_r = jax.tree_util.tree_flatten_with_path(_np(ref_grads))[0]
    flat_p = leaves(grads)
    assert len(flat_r) == len(flat_p)
    for (path, r), p in zip(flat_r, flat_p):
        p = p.numpy()
        assert p.shape == r.shape, path
        tol = 1e-4 * float(np.abs(r).max())
        assert float(np.abs(p - r).max()) <= tol, (path, np.abs(p - r).max(),
                                                   tol)


def test_remat_changes_neither_loss_nor_grads():
    _, cfg = _cfgs()
    params = _ref_state()["params"]
    batch = _batch(cfg, step=3)
    runs = {r: _port_loss_and_grads(cfg, params, batch, r)
            for r in ("none", "dots", "full")}
    base_loss, _, base = runs["none"]
    for r in ("dots", "full"):
        loss, _, grads = runs[r]
        assert abs(loss - base_loss) < 1e-5
        for a, b in zip(leaves(grads), leaves(base)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                       rtol=1e-4)
    with pytest.raises(ValueError):
        MT._maybe_remat(lambda x: x, "most")


def test_serving_forward_saves_nothing_for_a_backward():
    _, cfg = _cfgs()
    state = train_state_from_reference(cfg, _ref_state(), "cpu")
    model = MT.TransformerLM.from_stacked(cfg, state["params"])
    MT.bind_stacked_grads(model, state["params"])
    logits, _ = MT.forward(cfg, model, device_put_batch(_batch(cfg), "cpu"))
    assert logits.grad_fn is None and not logits.requires_grad


# ---------------------------------------------------------------------------
# B2's and B3's backward against jax.grad of their oracles
# ---------------------------------------------------------------------------


# (3, 5, 64) as the reduced configs; ragged row counts and D = 1000, which
# the kernel's vectors a thread do not divide (125 bf16 vectors of 8, 250
# f32 vectors of 4, over 256 threads)
B2_GRAD_SHAPES = [(3, 5, 64), (7, 1000), (3, 11, 200)]


@pytest.mark.parametrize("shape", B2_GRAD_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_backward_matches_jax_grad(dtype, shape):
    """B2's gradient through ``RmsNormFn`` (on the CPU its plain version
    ``rms_norm_backward_ref``, which the gradient kernel's wrapper takes for
    CPU tensors, launching nothing) against ``jax.vjp`` of the oracle."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    _, vjp = jax.vjp(lambda a, s: ref_rms_norm(a, s, 1e-5), jx,
                     jnp.asarray(scale))
    rdx, rds = vjp(jg)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    y = rms_norm(tx, ts, eps=1e-5)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == \
        "RmsNormFnBackward"
    before = rms_norm_backward_cuda.launches
    y.backward(torch.from_numpy(g).to(tdt))
    assert rms_norm_backward_cuda.launches == before  # the CPU's plain one
    rdx = np.asarray(rdx.astype(jnp.float32))
    dx = tx.grad.float().numpy()
    if dtype == "float32":
        assert np.abs(dx - rdx).max() <= 1e-5 * np.abs(rdx).max()
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(rdx), 1e-30))) - 7)
        assert np.all(np.abs(dx - rdx) <= ulp)
    assert np.abs(ts.grad.numpy() - np.asarray(rds)).max() <= \
        1e-5 * np.abs(np.asarray(rds)).max()


# (B, H, K, S, D, causal, window, block)
B3_CASES = [(2, 4, 4, 40, 16, True, 0, 256),
            (1, 4, 2, 300, 16, True, 0, 256),      # GQA; 256 does not divide
            (1, 6, 2, 50, 16, True, 12, 16),       # a window, blocks of 16
            (2, 4, 1, 33, 16, False, 0, 8),        # unmasked, MQA
            (1, 2, 2, 64, 64, True, 0, 24)]


@pytest.mark.parametrize("formulation", ["ops", "kernel"])
@pytest.mark.parametrize("case", B3_CASES, ids=str)
def test_flash_backward_matches_jax_grad(case, formulation):
    """Both formulations of the plain backward: "ops" recomputes the
    softmax itself; "kernel" takes o and lse from the forward's plain
    version (``return_lse``), as B3's backward kernel does."""
    b, h, kh, s, d, causal, window, block = case
    rng = np.random.default_rng(2)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, kh, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kh, s, d)).astype(np.float32)
    do = rng.standard_normal((b, h, s, d)).astype(np.float32)
    group = h // kh

    def f(q, k, v):  # the oracle takes H K/V heads: repeat each K/V head
        k, v = (jnp.repeat(t, group, axis=1) for t in (k, v))
        return ref_attention(q, k, v, causal=causal, window=window)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(t) for t in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    saved = {}
    if formulation == "kernel":
        saved["o"], saved["lse"] = flash_attention_cuda(
            tq, tk, tv, causal=causal, window=window, return_lse=True)
    got = flash_attention_backward(tq, tk, tv, tdo, causal=causal,
                                   window=window, block=block, **saved)
    for name, a, r in zip("qkv", got, want):
        assert a.shape == r.shape
        err = np.abs(a.numpy() - r).max()
        assert err <= 1e-4 * np.abs(r).max(), (name, err)
    # through the Function, at its own block size
    tq, tk, tv = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    o = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    o.backward(tdo)
    for name, t, r in zip("qkv", (tq, tk, tv), want):
        assert np.abs(t.grad.numpy() - r).max() <= 1e-4 * np.abs(r).max()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_bf16_rounds_dk_dv_once(causal):
    """In bf16, dK and dV summed over many query blocks land within one
    bf16 ulp of the one-block sum: the blocks' products are added in f32
    and rounded once, as jax.grad rounds them, not block by block."""
    rng = np.random.default_rng(4)
    q, do = (torch.from_numpy(rng.standard_normal((1, 4, 128, 16)).astype(
        np.float32)).bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 128, 16)).astype(
        np.float32)).bfloat16() for _ in range(2))
    many = flash_attention_backward(q, k, v, do, causal=causal, block=8)
    one = flash_attention_backward(q, k, v, do, causal=causal, block=128)
    for name, a, r in zip("qkv", many, one):
        assert a.dtype == torch.bfloat16
        a, r = a.float().numpy(), r.float().numpy()
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(r), 1e-30))) - 7)
        assert np.all(np.abs(a - r) <= ulp), (name, np.abs(a - r).max())


def test_flash_backward_of_cpu_tensors_launches_nothing():
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (1, 2, 24, 16)).astype(np.float32)) for _ in range(4))
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    before = (flash_attention_backward_cuda.launches,
              flash_attention_backward_cuda.launches_tc)
    got = flash_attention_backward_cuda(q, k, v, o, lse, do)
    want = flash_attention_backward(q, k, v, do, o=o, lse=lse)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (flash_attention_backward_cuda.launches,
            flash_attention_backward_cuda.launches_tc) == before


def _meta(*shape):
    return torch.zeros(shape, device="meta")


# the forward wrapper's refusals (tests/test_torch_flash_attention.py)
@pytest.mark.parametrize("args,exc", [
    ((_meta(1, 2, 16, 16),) * 3, ValueError),
    ((torch.zeros(1, 2, 16, 16), torch.zeros(1, 3, 16, 16),
      torch.zeros(1, 3, 16, 16)), ValueError),
    ((torch.zeros(1, 2, 16, 16), torch.zeros(1, 2, 8, 16),
      torch.zeros(1, 2, 8, 16)), ValueError),
    ((torch.zeros(1, 2, 16, 16), torch.zeros(1, 2, 16, 16,
                                             dtype=torch.bfloat16),
      torch.zeros(1, 2, 16, 16)), TypeError),
    ((torch.zeros(2, 16, 16),) * 3, ValueError),
    ((torch.zeros(1, 2, 16, 16, dtype=torch.float16),) * 3, TypeError),
    ((torch.zeros(1, 2, 16, 16), torch.zeros(1, 2, 16, 8),
      torch.zeros(1, 2, 16, 8)), ValueError),
    ((torch.zeros(1, 2, 16, 16), torch.zeros(1, 2, 16, 16),
      torch.zeros(1, 1, 16, 16)), ValueError),
])
def test_flash_backward_refuses_what_the_kernel_does_not_take(args, exc):
    q = args[0]
    lse = torch.zeros(q.shape[:-1], device=q.device)
    with pytest.raises(exc):
        flash_attention_backward_cuda(*args, torch.zeros_like(q), lse,
                                      torch.zeros_like(q))


@pytest.mark.parametrize("which", ["o", "lse", "do"])
def test_flash_backward_refuses_saved_tensors_that_do_not_fit(which):
    q = torch.zeros(1, 2, 16, 16)
    ops = dict(o=torch.zeros_like(q), lse=torch.zeros(1, 2, 16),
               do=torch.zeros_like(q))
    ops[which] = ops[which][..., :8]
    with pytest.raises(ValueError):
        flash_attention_backward_cuda(q, q, q, ops["o"], ops["lse"],
                                      ops["do"])
    ops[which] = torch.zeros(ops[which].shape[:-1] + (16,),
                             dtype=torch.float64)
    with pytest.raises(TypeError):
        flash_attention_backward_cuda(q, q, q, ops["o"], ops["lse"],
                                      ops["do"])


def test_functions_save_nothing_without_a_gradient(monkeypatch):
    x = torch.ones(2, 64)
    assert rms_norm(x, torch.ones(64)).grad_fn is None
    q = torch.ones(1, 2, 8, 16)
    # no log-sum-exp is asked of the forward without a gradient
    asked = []
    real = flash_attention_cuda

    def spy(*a, **kw):
        asked.append(kw.get("return_lse", False))
        return real(*a, **kw)

    monkeypatch.setattr(ops_mod, "flash_attention_cuda", spy)
    assert flash_attention(q, q, q).grad_fn is None
    assert asked == [False]
    q.requires_grad_(True)
    assert flash_attention(q, q, q).grad_fn is not None
    assert asked == [False, True]
    q.requires_grad_(False)
    with torch.no_grad():
        assert rms_norm(x.requires_grad_(True), torch.ones(64)).grad_fn \
            is None
    assert issubclass(RmsNormFn, torch.autograd.Function)
    assert issubclass(FlashAttentionFn, torch.autograd.Function)


# ---------------------------------------------------------------------------
# The train state, and train() end to end
# ---------------------------------------------------------------------------


def test_train_state_carries_across_both_ways():
    _, cfg = _cfgs("bfloat16")
    ref = _ref_state("bfloat16")
    port = train_state_from_reference(cfg, ref, "cpu")
    assert port["params"]["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert port["opt"]["m"]["layers"]["attn"]["wq"].dtype == torch.float32
    back = state_to_numpy(port)
    flat_r = jax.tree.leaves(ref)
    flat_b = jax.tree.leaves(back)
    assert len(flat_r) == len(flat_b)
    for r, b in zip(flat_r, flat_b):
        if r.dtype == ml_dtypes.bfloat16:
            assert b.dtype == np.uint16
        assert _bits(r) == _bits(b)
    with pytest.raises(ValueError):
        bad = dict(ref, params=dict(ref["params"], final_norm={}))
        train_state_from_reference(cfg, bad, "cpu")


def test_train_matches_reference_from_the_same_checkpoint(tmp_path):
    """Both packages resume from the reference's init_train_state, saved by
    the reference's Checkpointer at step 0, and train 5 steps of the
    reduced config in bf16; then each final checkpoint restores in the
    other package."""
    rcfg = ref_reduced(ref_get_config(ARCH))
    state = RS.init_train_state(rcfg, jax.random.PRNGKey(0))
    for name in ("ref", "port"):
        RefCheckpointer(str(tmp_path / name)).save(0, state, blocking=True)
    kw = dict(steps=5, log_every=0, global_batch=4, seq_len=32)
    ref = RT.train(ARCH, checkpoint_dir=str(tmp_path / "ref"), **kw)
    port = T.train(ARCH, checkpoint_dir=str(tmp_path / "port"),
                   device="cpu", **kw)
    assert port["steps"] == ref["steps"] == 5
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-2)
    assert port["losses"][0] == pytest.approx(ref["losses"][0], rel=1e-3)
    assert port["final_loss"] < port["initial_loss"]

    _, cfg = _cfgs("bfloat16")
    template = train_state_from_reference(cfg, _np(state), "cpu")
    into_port = Checkpointer(str(tmp_path / "ref")).restore(5, template)
    ref_final = _np(RefCheckpointer(str(tmp_path / "ref")).restore(5, state))
    for a, r in zip(jax.tree.leaves(state_to_numpy(into_port)),
                    jax.tree.leaves(ref_final)):
        assert _bits(a) == _bits(r)
    into_ref = _np(RefCheckpointer(str(tmp_path / "port")).restore(5, state))
    port_final = state_to_numpy(Checkpointer(str(tmp_path / "port")).restore(
        5, train_state_from_reference(cfg, _np(state), "cpu")))
    for r, a in zip(jax.tree.leaves(into_ref), jax.tree.leaves(port_final)):
        assert _bits(a) == _bits(r)
    assert int(into_ref["step"]) == int(into_ref["opt"]["count"]) == 5


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b"])
def test_train_refuses_the_families_not_yet_held(arch):
    """Only the VLM, whose train() fails in the reference too (its labels
    cover the tokens, its logits the patches as well)."""
    with pytest.raises(NotImplementedError, match="labels"):
        T.train(arch, steps=1, device="cpu")


def test_train_refuses_a_mesh():
    """What train(mesh=...) still refuses: a mesh whose size differs from
    the world (one that is no DeviceMesh, and a 2×2 mesh asked for in a
    world of one), and an Adafactor config, naming the reference caveat
    (its train(mesh=...) hands AdamW's state to an Adafactor step)."""
    from repro_torch.launch import mesh as MESH

    with pytest.raises(ValueError, match="world size 1"):
        T.train(ARCH, steps=1, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="4 ranks"):
        MESH.make_mesh_compat((2, 2), ("data", "model"), device="cpu")
    mesh = MESH.make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    try:
        ada = dataclasses.replace(reduced(get_config(ARCH)),
                                  optimizer="adafactor")
        with pytest.raises(NotImplementedError,
                           match="Adafactor.*init_factored_state"):
            T.train(ada, use_reduced=False, steps=1, mesh=mesh)
    finally:
        MESH.release_process_group()
