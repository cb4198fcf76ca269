"""The training path on the card: B2's and B3's gradients against autograd
through their plain versions, a train step whose forward, recompute and
backward never reach the plain versions or a library attention, the
kernels' launches a step, and ``train()``. These need a CUDA card and skip
elsewhere; the file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_card.py

Tolerances (f32): B2's dx and dscale within 1e-5 of their max |·|, B3's dq,
dk and dv within 1e-4 of theirs.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.data import SyntheticLMStream, device_put_batch
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_attention import kernel as b3
from repro_torch.kernels.flash_attention import ref as b3_ref
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm import kernel as b2
from repro_torch.kernels.rmsnorm import ref as b2_ref
from repro_torch.kernels.rmsnorm import rms_norm_ref
from repro_torch.kernels.rmsnorm.kernel import rms_norm_cuda
from repro_torch.kernels.rmsnorm.ops import rms_norm
from repro_torch.launch import train as T
from repro_torch.launch.steps import init_train_state
from repro_torch.models import transformer as MT
from repro_torch.optim import AdamWConfig

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _grads(fn, inputs, g):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    fn(*leaves).backward(g)
    return [t.grad for t in leaves]


@pytest.mark.parametrize("shape", [(2, 64, 3072), (3, 5, 1024)])
def test_rmsnorm_gradient_matches_plain(shape):
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(shape) * 2).astype(
        np.float32)).cuda()
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, shape[-1]).astype(
        np.float32)).cuda()
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
    n = rms_norm_cuda.launches
    got = _grads(lambda a, s: rms_norm(a, s), (x, scale), g)
    assert rms_norm_cuda.launches == n + 1
    want = _grads(lambda a, s: rms_norm_ref(a, s), (x, scale), g)
    for a, r in zip(got, want):
        assert float((a - r).abs().max()) <= 1e-5 * float(r.abs().max())


@pytest.mark.parametrize("b,h,kh,s,d,causal,window", [
    (1, 8, 2, 300, 128, True, 0), (2, 4, 4, 257, 64, True, 64),
    (1, 4, 1, 130, 16, False, 0)])
def test_flash_gradient_matches_plain(b, h, kh, s, d, causal, window):
    rng = np.random.default_rng(1)

    def draw(heads):
        return torch.from_numpy(rng.standard_normal(
            (b, heads, s, d)).astype(np.float32)).cuda()

    q, k, v, do = draw(h), draw(kh), draw(kh), draw(h)
    n = flash_attention_cuda.launches
    got = _grads(lambda *t: flash_attention(*t, causal=causal,
                                            window=window), (q, k, v), do)
    assert flash_attention_cuda.launches == n + 1
    want = _grads(lambda *t: attention_ref(*t, causal=causal, window=window),
                  (q, k, v), do)
    for a, r in zip(got, want):
        assert float((a - r).abs().max()) <= 1e-4 * float(r.abs().max())


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
                      (b3, "attention_ref"), (b3_ref, "attention_ref"),
                      (F, "scaled_dot_product_attention")):
        monkeypatch.setattr(mod, name, _raise)
    n2, n3 = rms_norm_cuda.launches, flash_attention_cuda.launches_tc
    metrics = T.train_step(cfg, model, state, grads, batch, AdamWConfig())
    torch.cuda.synchronize()
    n = cfg.num_layers
    # remat "full": ln1, ln2 a layer and the final norm, then ln1, ln2 a
    # layer again in the recompute; B3 once a layer and once in the
    # recompute, all on the tensor-core kernel
    assert cfg.remat == "full"
    assert rms_norm_cuda.launches - n2 == (2 * n + 1) + 2 * n
    assert flash_attention_cuda.launches_tc - n3 == 2 * n
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


def test_train_runs_on_the_card_by_default():
    out = T.train("llama3.2-3b", steps=3, log_every=0, global_batch=2,
                  seq_len=64)
    assert out["steps"] == 3
    assert all(np.isfinite(out["losses"]))
