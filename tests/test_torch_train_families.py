"""Training of the five families beyond the dense one (RWKV, hybrid, MoE,
enc-dec, VLM) against the JAX package on the CPU.

Each family at its reduced config in float32, weights drawn by the
reference's ``init_train_state`` and carried across as numpy. ``forward_loss``
and every gradient leaf against ``jax.value_and_grad`` of the reference's
``forward_loss`` on the same batch (``SyntheticLMStream``'s, byte-identical
in both packages; the VLM on the reference's ``synthetic_batch``, whose
labels cover every position and whose loss mask is zero over the patches);
``train()`` in both packages from the same reference checkpoint for the
four families it trains; B4's gradient (``WkvFn``, whose backward on the
CPU is the plain ``wkv_backward_ref``) against ``jax.grad`` of the
reference's ``wkv_ref``; and the refusals.

Tolerances: ``forward_loss`` within 1e-5 relative, each gradient leaf within
1e-4 of the leaf's max |g| (the two packages sum in other orders), as
``tests/test_torch_train.py`` holds llama's; ``train()``'s f32 losses within
1e-5 relative a step; B4's gradients within 1e-5 of each one's max |·|
(both f32 step by step). The reference's chunked WKV runs at the reduced
config's ``ssm_chunk`` of 8, where it is finite.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as RM
from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import ShapeSpec as RefShapeSpec
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.kernels.wkv.ref import wkv_ref as ref_wkv_ref
from repro.launch import steps as RS
from repro.launch import train as RT
from repro_torch._tree import leaves
from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.data import SyntheticLMStream, device_put_batch
from repro_torch.kernels.wkv.ops import wkv
from repro_torch.launch import train as T
from repro_torch.models import transformer as MT
from repro_torch.models.weights import train_state_from_reference

SEQ = 32
TRAINABLE = ["rwkv6-1.6b", "zamba2-7b", "mixtral-8x7b", "seamless-m4t-medium"]
VLM = "llava-next-mistral-7b"


def _cfgs(arch):
    return (dataclasses.replace(ref_reduced(ref_get_config(arch)),
                                dtype="float32"),
            dataclasses.replace(reduced(get_config(arch)), dtype="float32"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _ref_init(arch):
    """The reference's f32 ``init_train_state`` as numpy, drawn once a
    family (it takes seconds)."""
    rcfg, _ = _cfgs(arch)
    return _np(RS.init_train_state(rcfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    """The reference's f32 train state; for RWKV with the token shifts and
    the bonus drawn from a numpy seed, so that every term of the time mix
    carries a gradient (random init leaves them at zero)."""
    rcfg, _ = _cfgs(arch)
    state = jax.tree.map(np.copy, _ref_init(arch))
    if rcfg.family == "ssm":
        rng = np.random.default_rng(7)
        tm = state["params"]["layers"]["tm"]
        for name, draw in (("mu", lambda s: rng.uniform(0, 1, s)),
                           ("mu_c", lambda s: rng.uniform(0, 1, s)),
                           ("bonus_u", lambda s: rng.standard_normal(s))):
            tm[name] = draw(tm[name].shape).astype(np.float32)
    return state


def _batch(arch):
    rcfg, cfg = _cfgs(arch)
    if cfg.frontend == "vision":  # its bf16 patches as exact f32 arrays
        batch = RM.synthetic_batch(rcfg, RefShapeSpec("t", "train", SEQ, 2))
        return {k: np.array(v, np.float32 if v.dtype == jnp.bfloat16
                            else v.dtype) for k, v in batch.items()}
    return SyntheticLMStream(cfg, ShapeSpec("t", "train", SEQ, 2)).batch_at(0)


@pytest.mark.parametrize("arch", TRAINABLE + [VLM])
def test_forward_loss_and_every_gradient_match_jax_grad(arch):
    rcfg, cfg = _cfgs(arch)
    state = _ref_state(arch)
    batch = _batch(arch)

    def loss_fn(p):
        return RM.forward_loss(rcfg, p, jax.tree.map(jnp.asarray, batch),
                               remat="none")

    (ref_loss, ref_metrics), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree.map(jnp.asarray, state["params"]))

    port = train_state_from_reference(cfg, state, "cpu")
    model = MT.TransformerLM.from_stacked(cfg, port["params"])
    grads = MT.bind_stacked_grads(model, port["params"])
    loss, metrics = MT.forward_loss(cfg, model,
                                    device_put_batch(batch, "cpu"),
                                    remat="none")
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    for key in ("ce_loss", "moe_aux"):
        assert float(metrics[key].detach()) == pytest.approx(
            float(ref_metrics[key]), rel=1e-5, abs=1e-7), key
    flat_r = jax.tree_util.tree_flatten_with_path(_np(ref_grads))[0]
    flat_p = leaves(grads)
    assert len(flat_r) == len(flat_p)
    for (path, r), p in zip(flat_r, flat_p):
        p = p.numpy()
        assert p.shape == r.shape, path
        tol = 1e-4 * float(np.abs(r).max())
        assert float(np.abs(p - r).max()) <= tol, (path, np.abs(p - r).max(),
                                                   tol)


@pytest.mark.parametrize("arch", TRAINABLE)
def test_train_matches_reference_from_the_same_checkpoint(arch, tmp_path,
                                                          monkeypatch):
    """Both packages resume from the reference's f32 init_train_state,
    saved by the reference's Checkpointer at step 0, and train 3 steps of
    the reduced config; each step's loss agrees within 1e-5."""
    rcfg, cfg = _cfgs(arch)
    state = _ref_init(arch)
    for name in ("ref", "port"):
        RefCheckpointer(str(tmp_path / name)).save(0, state, blocking=True)
    # the reference's train() builds its config by name: make it f32
    monkeypatch.setattr(RT, "reduce_cfg", lambda c: dataclasses.replace(
        ref_reduced(c), dtype="float32"))
    kw = dict(steps=3, log_every=0, global_batch=2, seq_len=SEQ)
    ref = RT.train(arch, checkpoint_dir=str(tmp_path / "ref"), **kw)
    port = T.train(cfg, use_reduced=False,
                   checkpoint_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert port["steps"] == ref["steps"] == 3
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)
    assert all(np.isfinite(port["losses"]))


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("s", [1, 63, 64, 130])
def test_wkv_gradient_matches_jax_grad(s, d):
    """B4's gradient through ``WkvFn`` (the plain backward on the CPU)
    against ``jax.vjp`` of the reference's oracle, lw down to -20."""
    rng = np.random.default_rng(s + d)
    b, h = 2, 2
    r, k, v, do = (rng.standard_normal((b, h, s, d)).astype(np.float32)
                   for _ in range(4))
    lw = rng.uniform(-20.0, 0.0, (b, h, s, d)).astype(np.float32)
    lw[:, :, ::3] = rng.uniform(-0.05, 0.0, lw[:, :, ::3].shape)  # weak too
    u = rng.standard_normal((h, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: ref_wkv_ref(*a)[0],
                     *map(jnp.asarray, (r, k, v, lw, u)))
    want = [np.asarray(t) for t in vjp(jnp.asarray(do))]
    ins = [torch.from_numpy(t).requires_grad_(True) for t in (r, k, v, lw, u)]
    out, _ = wkv(*ins)
    assert type(out.grad_fn).__name__ == "WkvFnBackward"
    out.backward(torch.from_numpy(do))
    for name, t, w in zip(("r", "k", "v", "lw", "u"), ins, want):
        assert t.grad.shape == w.shape, name
        err = float(np.abs(t.grad.numpy() - w).max())
        assert err <= 1e-5 * max(float(np.abs(w).max()), 1e-30), (name, err)


def test_wkv_refuses_a_state_under_grad_and_a_final_state_gradient():
    x = torch.ones(1, 2, 5, 16)
    u = torch.zeros(2, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="initial state"):
        wkv(x, x, x, -x, u, state=torch.zeros(1, 2, 16, 16))
    out, final = wkv(x, x, x, -x, u)
    with pytest.raises(NotImplementedError, match="final state"):
        (out.sum() + final.sum()).backward()
    # serving (nothing requires a gradient) keeps the state path
    with torch.no_grad():
        st = torch.zeros(1, 2, 16, 16)
        wkv(x, x, x, -x, u, state=st)
        assert float(st.abs().max()) > 0


def test_train_refuses_the_vlm_naming_the_reference_caveat():
    with pytest.raises(NotImplementedError,
                       match="cross_entropy_loss.*synthetic_batch"):
        T.train(VLM, steps=1, device="cpu")
    # the reference's own train() fails there too
    with pytest.raises(ValueError):
        RT.train(VLM, steps=1, log_every=0, global_batch=2, seq_len=SEQ)


@pytest.mark.parametrize("arch", TRAINABLE + [VLM])
def test_train_refuses_a_mesh_for_every_family(arch):
    """What train(mesh=...) still refuses: a mesh that is not a DeviceMesh
    over this process group's world (a 16×16 stand-in in a world of one),
    and the VLM on a mesh too, naming the reference caveat."""
    import types

    from repro_torch.launch import mesh as MESH

    fake = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((16, 16)))
    exc, match = ((NotImplementedError, "labels") if arch == VLM
                  else (ValueError, "world size 1"))
    with pytest.raises(exc, match=match):
        T.train(arch, steps=1, device="cpu", mesh=fake)
    if arch == VLM:
        mesh = MESH.make_mesh_compat((1, 1), ("data", "model"), device="cpu")
        try:
            with pytest.raises(NotImplementedError,
                               match="cross_entropy_loss.*synthetic_batch"):
                T.train(arch, steps=1, mesh=mesh)
        finally:
            MESH.release_process_group()
