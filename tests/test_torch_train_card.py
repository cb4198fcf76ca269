"""The training path on the card: B2's, B3's and B4's gradients against
autograd through their plain versions, a train step whose forward,
recompute and backward never reach the plain versions or a library
attention, the kernels' launches a step, ``train()``, the RWKV gradient
through B4's backward kernel at rwkv6-1.6b's width, and one bf16 step of
every family. These need a CUDA card and skip elsewhere; the file imports
no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_card.py

Tolerances (f32): B2's dx and dscale within 1e-5 of their max |·| (bf16:
dx within 1.5 times plain bf16's own distance from the f32 gradient), B3's dq,
dk and dv within 1e-4 of theirs (in bf16, each within 1.5 times the plain
version's own bf16 distance from its f32 gradient, the smoke's
GRAD_BF16_FACTOR; B2's and B3's backward kernels repeat bit for bit), B4's
dr, dk, dv, dlw and du within 1e-4 of theirs (its sequential backward
recomputes the states in f32 step by step, as the plain version does; the
chunked one forms them in 3xTF32 products, as the forward's chunked kernel
does); the RWKV
model's gradient leaves within 1e-3 of their max |g| (its forward is the
chunked 3xTF32 kernel).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.data import SyntheticLMStream, device_put_batch
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_attention import kernel as b3
from repro_torch.kernels.flash_attention import ref as b3_ref
from repro_torch.kernels.flash_attention import ops as b3_ops
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_backward_cuda, flash_attention_cuda, kernel_for)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm import kernel as b2
from repro_torch.kernels.rmsnorm import ref as b2_ref
from repro_torch.kernels.rmsnorm import rms_norm_ref
from repro_torch.kernels.rmsnorm.kernel import (rms_norm_backward_cuda,
                                                rms_norm_cuda)
from repro_torch.kernels.rmsnorm.ops import rms_norm
from repro_torch.kernels.wkv import kernel as b4
from repro_torch.kernels.wkv.kernel import wkv_backward_cuda, wkv_cuda
from repro_torch.kernels.wkv.ops import wkv
from repro_torch.kernels.wkv.ref import wkv_ref
from repro_torch.launch import train as T
from repro_torch.launch.steps import init_train_state
from repro_torch._tree import flatten
from repro_torch.models import attention as attn
from repro_torch.models import layers as ML
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import synthetic_batch
from repro_torch.models import transformer as MT
from repro_torch.optim import AdamWConfig

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _grads(fn, inputs, g):
    """Each input's gradient, zeros where the output does not reach it (lw
    at S = 1 reaches only the final state)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    fn(*leaves).backward(g)
    return [torch.zeros_like(t) if t.grad is None else t.grad
            for t in leaves]


# the seven shapes the families train B2 at (llama's, rwkv's, zamba2's,
# mixtral's, seamless's, llava's two), and two small ones
B2_GRAD_SHAPES = [(2, 2048, 3072), (2, 2048, 2048), (2, 2048, 3584),
                  (2, 2048, 4096), (2, 2048, 1024), (2, 5760, 4096),
                  (2, 2880, 4096), (2, 64, 3072), (3, 5, 1024)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", B2_GRAD_SHAPES, ids=str)
def test_rmsnorm_gradient_matches_plain(shape, dtype):
    """Through ``RmsNormFn`` (B2's forward, then its gradient kernel, each
    launched once) against autograd through the plain version: f32 within
    1e-5 of each gradient's max; bf16 dx within GRAD_BF16_FACTOR times
    plain bf16's own distance from the f32 gradient, dscale within 1e-5 of
    its max. The gradient kernel twice on the same inputs: the same
    bits."""
    rng = np.random.default_rng(0)
    dt = getattr(torch, dtype)
    x = torch.from_numpy((rng.standard_normal(shape) * 2).astype(
        np.float32)).cuda().to(dt)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, shape[-1]).astype(
        np.float32)).cuda()
    g = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).cuda().to(dt)
    n, nb = rms_norm_cuda.launches, rms_norm_backward_cuda.launches
    got = _grads(lambda a, s: rms_norm(a, s), (x, scale), g)
    assert rms_norm_cuda.launches == n + 1
    assert rms_norm_backward_cuda.launches == nb + 1
    f32 = _grads(lambda a, s: rms_norm_ref(a, s), (x.float(), scale),
                 g.float())
    want = _grads(lambda a, s: rms_norm_ref(a, s), (x, scale), g)
    for name, a, p, r in zip(("x", "scale"), got, want, f32):
        assert a.dtype == p.dtype, name
        err = float((a.float() - r).abs().max())
        limit = 1e-5 * float(r.abs().max())
        if dtype == "bfloat16" and name == "x":
            limit = max(limit, GRAD_BF16_FACTOR * float(
                (p.float() - r).abs().max()))
        assert err <= limit, (name, err, limit)
    first = rms_norm_backward_cuda(x, scale, g)
    again = rms_norm_backward_cuda(x, scale, g)
    assert rms_norm_backward_cuda.launches == nb + 3
    assert all(torch.equal(a, b) for a, b in zip(first, again))


# (B, H, K, S, D, causal, window, dtype): head dims 16, 64, 112 and 128,
# GQA groups 1, 3 and 4, causal, windowed and unmasked, S ragged
B3_GRAD_CASES = [
    (1, 8, 2, 300, 128, True, 0, "float32"),
    (2, 4, 4, 257, 64, True, 64, "float32"),
    (1, 4, 1, 130, 16, False, 0, "float32"),
    (1, 6, 2, 333, 112, True, 0, "float32"),
    (1, 6, 2, 333, 128, True, 0, "bfloat16"),
    (2, 8, 2, 257, 128, True, 100, "bfloat16"),
    (2, 4, 1, 1024, 128, True, 256, "bfloat16"),
    (1, 2, 2, 3, 128, True, 0, "bfloat16"),
    (1, 4, 4, 333, 64, False, 0, "bfloat16"),
    (1, 4, 4, 257, 64, True, 0, "bfloat16"),
    (1, 6, 2, 300, 112, True, 0, "bfloat16"),
    (1, 4, 1, 257, 112, False, 0, "bfloat16"),
    (1, 3, 1, 333, 16, True, 0, "bfloat16"),
    (1, 4, 4, 200, 16, False, 0, "bfloat16"),
]
GRAD_BF16_FACTOR = 1.5


def _b3_inputs(b, h, kh, s, d, dtype, seed=1):
    rng = np.random.default_rng(seed)

    def draw(heads):
        return torch.from_numpy(rng.standard_normal(
            (b, heads, s, d)).astype(np.float32)).cuda().to(
                getattr(torch, dtype))

    return draw(h), draw(kh), draw(kh), draw(h)


@pytest.mark.parametrize("b,h,kh,s,d,causal,window,dtype", B3_GRAD_CASES,
                         ids=str)
def test_flash_gradient_matches_plain(b, h, kh, s, d, causal, window, dtype):
    """Through ``FlashAttentionFn`` (B3's forward, then its backward
    kernel, each launched once) against autograd through the plain
    version: f32 within 1e-4 of each gradient's max, bf16 within
    GRAD_BF16_FACTOR times plain bf16's own distance from the f32
    gradient."""
    q, k, v, do = _b3_inputs(b, h, kh, s, d, dtype)
    tc = kernel_for(q.dtype, d) == "tensor_core"
    n = flash_attention_cuda.launches
    nb = flash_attention_backward_cuda.launches
    nb_tc = flash_attention_backward_cuda.launches_tc
    got = _grads(lambda *t: flash_attention(*t, causal=causal,
                                            window=window), (q, k, v), do)
    assert flash_attention_cuda.launches == n + 1
    assert flash_attention_backward_cuda.launches == nb + 1
    assert flash_attention_backward_cuda.launches_tc == nb_tc + tc
    plain = functools.partial(attention_ref, causal=causal, window=window)
    f32 = _grads(plain, [t.float() for t in (q, k, v)], do.float())
    if dtype == "float32":
        for a, r in zip(got, f32):
            assert float((a - r).abs().max()) <= 1e-4 * float(
                r.abs().max())
        return
    want = _grads(plain, (q, k, v), do)
    for name, a, p, r in zip("qkv", got, want, f32):
        assert a.dtype == torch.bfloat16
        err = float((a.float() - r).abs().max())
        own = float((p.float() - r).abs().max())
        limit = max(GRAD_BF16_FACTOR * own, 1e-4 * float(r.abs().max()))
        assert err <= limit, (name, err, own)


@pytest.mark.parametrize("d,dtype", [(128, "bfloat16"), (112, "bfloat16"),
                                     (64, "bfloat16"), (16, "bfloat16"),
                                     (128, "float32")])
def test_flash_backward_repeats_bit_for_bit(d, dtype):
    """The backward kernels sum in a fixed order (no atomics): two calls on
    the same inputs give the same bits, and each call counts one launch."""
    q, k, v, do = _b3_inputs(2, 6, 2, 333, d, dtype, seed=2)
    o, lse = flash_attention_cuda(q, k, v, causal=True, window=200,
                                  return_lse=True)
    n = flash_attention_backward_cuda.launches
    first = flash_attention_backward_cuda(q, k, v, o, lse, do, causal=True,
                                          window=200)
    again = flash_attention_backward_cuda(q, k, v, o, lse, do, causal=True,
                                          window=200)
    assert flash_attention_backward_cuda.launches == n + 2
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_flash_lse_matches_plain_and_costs_the_serving_call_nothing():
    """``return_lse`` gives the plain log-sum-exp (log2 domain); without it
    the output is the same, bit for bit."""
    q, k, v, _ = _b3_inputs(2, 8, 2, 333, 128, "bfloat16", seed=3)
    o, lse = flash_attention_cuda(q, k, v, causal=True, return_lse=True)
    assert torch.equal(o, flash_attention_cuda(q, k, v, causal=True))
    want = b3_ref.attention_lse_ref(q, k, causal=True)
    assert float((lse - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


def _step_inputs(dtype="bfloat16"):
    cfg = dataclasses.replace(reduced(get_config("llama3.2-3b")),
                              dtype=dtype, head_dim=64, d_model=256,
                              num_heads=4, num_kv_heads=2)
    state = init_train_state(cfg, device="cuda")
    model = MT.TransformerLM.from_stacked(cfg, state["params"])
    grads = MT.bind_stacked_grads(model, state["params"])
    batch = device_put_batch(SyntheticLMStream(
        cfg, ShapeSpec("t", "train", 128, 2)).batch_at(0), "cuda")
    return cfg, model, state, grads, batch


def _raise(*args, **kwargs):
    raise AssertionError("a plain version or a library attention ran")


def test_train_step_never_reaches_the_plain_versions(monkeypatch):
    cfg, model, state, grads, batch = _step_inputs()
    for mod, name in ((b2, "rms_norm_ref"), (b2_ref, "rms_norm_ref"),
                      (b2, "rms_norm_backward_ref"),
                      (b2_ref, "rms_norm_backward_ref"),
                      (b3, "attention_ref"), (b3_ref, "attention_ref"),
                      (b3_ops, "flash_attention_backward"),
                      (F, "scaled_dot_product_attention")):
        monkeypatch.setattr(mod, name, _raise)
    n2, n3 = rms_norm_cuda.launches, flash_attention_cuda.launches_tc
    nb = flash_attention_backward_cuda.launches_tc
    n2b = rms_norm_backward_cuda.launches
    metrics = T.train_step(cfg, model, state, grads, batch, AdamWConfig())
    torch.cuda.synchronize()
    n = cfg.num_layers
    # remat "full": ln1, ln2 a layer and the final norm, then ln1, ln2 a
    # layer again in the recompute; B3 once a layer and once in the
    # recompute, all on the tensor-core kernel
    assert cfg.remat == "full"
    assert rms_norm_cuda.launches - n2 == (2 * n + 1) + 2 * n
    assert flash_attention_cuda.launches_tc - n3 == 2 * n
    # B2's gradient kernel once a norm of the forward
    assert rms_norm_backward_cuda.launches - n2b == 2 * n + 1
    # B3's backward kernel once a layer, on the tensor cores
    assert flash_attention_backward_cuda.launches_tc - nb == n
    assert bool(torch.isfinite(metrics["loss"]))
    assert all(bool(torch.isfinite(g).all())
               for g in grads["layers"]["mlp"].values())


def test_a_kernel_that_cannot_run_raises_on_the_card():
    q = torch.ones(1, 2, 16, 32, device="cuda", requires_grad=True)
    with pytest.raises(ValueError):  # head dim 32: no B3 kernel takes it
        flash_attention(q, q, q)
    x = torch.ones(2, 6, device="cuda", requires_grad=True)
    with pytest.raises(ValueError):  # d 6 is not a multiple of 4 f32s
        rms_norm(x, torch.ones(6, device="cuda"))
    # B2's gradient: g in x's dtype, contiguous; D as the forward's
    x, s = torch.ones(4, 64, device="cuda"), torch.ones(64, device="cuda")
    with pytest.raises(ValueError):
        rms_norm_backward_cuda(x, s, x.bfloat16())
    with pytest.raises(ValueError):
        rms_norm_backward_cuda(x, s, torch.ones(64, 4, device="cuda").t())
    with pytest.raises(ValueError):
        rms_norm_backward_cuda(x[:, :6], s[:6], x[:, :6])
    # B4's chunked backward takes head dim 64 only
    r = torch.zeros(1, 2, 70, 16, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        wkv_backward_cuda(r, r, r, r, torch.zeros(2, 16, device="cuda"), r,
                          kernel="tensor_core")


def test_train_runs_on_the_card_by_default():
    out = T.train("llama3.2-3b", steps=3, log_every=0, global_batch=2,
                  seq_len=64)
    assert out["steps"] == 3
    assert all(np.isfinite(out["losses"]))


# ---------------------------------------------------------------------------
# B4's backward, the RWKV gradient, and every family's bf16 step
# ---------------------------------------------------------------------------


def _wkv_inputs(b, h, s, d, lw=(-1.61, -0.64), seed=5):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) * 0.5
               for _ in range(3))
    lws = rng.uniform(*lw, (b, h, s, d)).astype(np.float32)
    u = (rng.standard_normal((h, d)) * 0.5).astype(np.float32)
    do = rng.standard_normal((b, h, s, d)).astype(np.float32)
    return [torch.from_numpy(t).cuda() for t in (r, k, v, lws, u, do)]


@pytest.mark.parametrize("b,h,s,d,lw", [
    (2, 4, 1, 64, (-1.61, -0.64)), (2, 4, 333, 64, (-1.61, -0.64)),
    (1, 3, 130, 16, (-1.61, -0.64)), (1, 2, 1, 16, (-1.61, -0.64)),
    (1, 2, 200, 64, (-20.0, 0.0)), (1, 2, 257, 64, (-0.01, 0.0)),
    (1, 2, 40, 64, (-1.61, -0.64)), (1, 2, 64, 64, (-1.61, -0.64)),
    (2, 32, 512, 64, (-20.0, 0.0)), (1, 4, 2048, 64, (-0.01, 0.0))])
def test_wkv_backward_matches_plain(b, h, s, d, lw):
    """The backward kernel ``kernel_for`` picks (the chunked one at head dim
    64 from S = 64, the sequential one below and at head dim 16) against
    autograd through ``wkv_ref``, and ``WkvFn`` (B4's forward, then the
    backward kernel) alike; twice for the same bits."""
    r, k, v, lws, u, do = _wkv_inputs(b, h, s, d, lw)
    tc = b4.kernel_for(s, d) == "tensor_core"
    n, n_tc = wkv_backward_cuda.launches, wkv_backward_cuda.launches_tc
    got = wkv_backward_cuda(r, k, v, lws, u, do)
    again = wkv_backward_cuda(r, k, v, lws, u, do)
    assert wkv_backward_cuda.launches == n + 2
    assert wkv_backward_cuda.launches_tc == n_tc + 2 * tc
    want = _grads(lambda *t: wkv_ref(*t)[0], (r, k, v, lws, u), do)
    for name, a, a2, w in zip(("r", "k", "v", "lw", "u"), got, again, want):
        assert a.shape == w.shape, name
        assert torch.equal(a, a2), name
        err = float((a - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (name, err)
    through = _grads(lambda *t: wkv(*t)[0], (r, k, v, lws, u), do)
    assert wkv_backward_cuda.launches == n + 3
    assert wkv_backward_cuda.launches_tc == n_tc + 3 * tc
    for a, w in zip(through, want):
        assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_wkv_refuses_what_its_gradient_cannot_give():
    r, k, v, lws, u, _ = _wkv_inputs(1, 2, 70, 64)
    r.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="initial state"):
        wkv(r, k, v, lws, u, state=torch.zeros(1, 2, 64, 64, device="cuda"))
    _, final = wkv(r, k, v, lws, u)
    with pytest.raises(NotImplementedError, match="final state"):
        final.sum().backward()


def _plain_versions(monkeypatch):
    """B2, B3 and B4 patched to their plain versions for autograd."""
    monkeypatch.setattr(ML, "_rms_norm_op",
                        lambda x, scale, eps: rms_norm_ref(x, scale, eps))
    monkeypatch.setattr(attn, "flash_attention",
                        lambda q, k, v, causal, window, q_offset=0:
                        attention_ref(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset))
    monkeypatch.setattr(rwkv_mod, "wkv",
                        lambda r, k, v, lw, u, state=None, chunk=64:
                        wkv_ref(r, k, v, lw, u, state))


def _family_step_inputs(arch, dtype, layers, seq, **changes):
    """(config, model, train state, gradient tree, batch): ``arch`` at
    ``layers`` layers with ``changes``, 2 x ``seq`` positions; a VLM takes
    ``synthetic_batch`` (labels over every position, the loss mask zero
    over the patches), the reference's own VLM step batch."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              dtype=dtype, **changes)
    state = init_train_state(cfg, device="cuda")
    model = MT.TransformerLM.from_stacked(cfg, state["params"])
    grads = MT.bind_stacked_grads(model, state["params"])
    shape = ShapeSpec("t", "train", seq, 2)
    if cfg.frontend == "vision":
        batch = synthetic_batch(cfg, shape, seed=0, device="cuda")
    else:
        batch = device_put_batch(SyntheticLMStream(cfg, shape).batch_at(0),
                                 "cuda")
    return cfg, model, state, grads, batch


def test_rwkv_gradient_reaches_every_leaf_through_b4(monkeypatch):
    """rwkv6-1.6b at full width, 2 layers, f32: forward_loss's backward
    through B4's forward and backward kernels against the same through the
    plain versions, leaf by leaf; no time-mix leaf is left at zero."""
    cfg, model, state, grads, batch = _family_step_inputs(
        "rwkv6-1.6b", "float32", 2, 128)
    # weights under which the token shift and the bonus count
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for name, draw in (("mu", lambda sh: rng.uniform(0, 1, sh)),
                           ("mu_c", lambda sh: rng.uniform(0, 1, sh)),
                           ("bonus_u", lambda sh: rng.standard_normal(sh))):
            leaf = state["params"]["layers"]["tm"][name]
            leaf.copy_(torch.from_numpy(draw(tuple(leaf.shape)).astype(
                np.float32)))

    def run():
        for _, g in flatten(grads):
            g.zero_()
        loss, _ = MT.forward_loss(cfg, model, batch)
        loss.backward()
        return float(loss.detach()), [(p, g.clone())
                                      for p, g in flatten(grads)]

    n4, nb = wkv_cuda.launches_tc, wkv_backward_cuda.launches
    nb_tc = wkv_backward_cuda.launches_tc
    loss, got = run()
    # remat full: the forward and the recompute on the chunked kernel, one
    # backward launch a layer, on the chunked backward (S = 128)
    assert wkv_cuda.launches_tc - n4 == 2 * cfg.num_layers
    assert wkv_backward_cuda.launches - nb == cfg.num_layers
    assert wkv_backward_cuda.launches_tc - nb_tc == cfg.num_layers
    with monkeypatch.context() as m:
        _plain_versions(m)
        plain_loss, want = run()
    assert loss == pytest.approx(plain_loss, rel=1e-5)
    for (path, a), (_, w) in zip(got, want):
        assert float(w.abs().max()) > 0, path
        err = float((a - w).abs().max())
        assert err <= 1e-3 * float(w.abs().max()), (path, err)
    tm = {p[-1]: g for p, g in got if "tm" in p}
    for name in ("w_r", "w_k", "w_v", "w_g", "decay_A", "decay_B",
                 "decay_base", "bonus_u", "mu"):
        assert float(tm[name].abs().max()) > 0, name


# (arch, config changes) for one bf16 step at 2 layers (zamba2: one group
# and a tail layer) of a narrow width, every kernel on its tensor-core path
FAMILIES = [
    ("rwkv6-1.6b", dict(d_model=256, d_ff=512, vocab_size=1024,
                        rwkv_decay_rank=16)),
    ("zamba2-7b", dict(num_layers=7, d_model=256, num_heads=4,
                       num_kv_heads=4, head_dim=64, d_ff=512,
                       vocab_size=1024)),
    ("mixtral-8x7b", dict(d_model=256, num_heads=4, num_kv_heads=2,
                          head_dim=64, d_ff=512, vocab_size=1024,
                          sliding_window=64)),
    ("seamless-m4t-medium", dict(encoder_layers=2, d_model=256, num_heads=4,
                                 num_kv_heads=4, head_dim=64, d_ff=512,
                                 vocab_size=1024)),
    ("llava-next-mistral-7b", dict(d_model=256, num_heads=4, num_kv_heads=2,
                                   head_dim=64, d_ff=512, vocab_size=1024,
                                   frontend_tokens=32)),
]


@pytest.mark.parametrize("arch,changes", FAMILIES, ids=[a for a, _ in
                                                        FAMILIES])
def test_bf16_train_step_of_every_family(arch, changes):
    changes = dict(changes)
    layers = changes.pop("num_layers", 2)
    cfg, model, state, grads, batch = _family_step_inputs(
        arch, "bfloat16", layers, 128, **changes)
    losses = [float(T.train_step(cfg, model, state, grads, batch,
                                 AdamWConfig(lr=1e-3))["loss"])
              for _ in range(2)]
    assert all(np.isfinite(losses)), losses
    for path, g in flatten(grads):
        assert bool(torch.isfinite(g.float()).all()), path
        assert float(g.float().abs().max()) > 0, path
