"""Kernels B2 (RMSNorm) and B3 (flash attention) on the card against their
plain PyTorch versions, and the dense path through them. These need a CUDA
card and skip elsewhere; the file imports no JAX, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_dense_card.py

Tolerances: f32 within 2e-5 absolute (the JAX package's kernel tests);
bf16 RMSNorm within one bf16 ulp of |y|, bf16 attention within 3e-2.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import models as M
from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.kernels.flash_attention import (
    attention_ref, flash_attention_cuda,
)
from repro_torch.kernels.rmsnorm import rms_norm_cuda, rms_norm_ref
from repro_torch.launch.serve import serve

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _bf16_ulp(y):
    mag = y.abs().float().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.parametrize("shape", [(3, 64), (5, 2048), (2, 3, 3072),
                                   (7, 5632), (1, 8192), (4, 6144)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy((rng.standard_normal(shape) * 2).astype(np.float32))
    x = x.to("cuda", dtype)
    scale = torch.from_numpy(
        rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)).cuda()
    before = rms_norm_cuda.launches
    y = rms_norm_cuda(x, scale)
    torch.cuda.synchronize()
    assert rms_norm_cuda.launches == before + 1
    ref = rms_norm_ref(x, scale)
    assert y.dtype == dtype and y.shape == x.shape
    err = (y.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 2e-5
    else:
        assert bool((err <= _bf16_ulp(ref)).all())
    assert torch.equal(y, rms_norm_cuda(x, scale))  # repeats bit for bit


@pytest.mark.parametrize("b,h,kh,s,d,dtype,causal,window", [
    (1, 4, 4, 333, 16, torch.float32, False, 0),
    (1, 8, 2, 100, 64, torch.float32, True, 32),
    (2, 4, 1, 130, 128, torch.bfloat16, True, 0),
    (1, 2, 2, 64, 128, torch.float32, True, 0),
    (2, 6, 2, 77, 64, torch.bfloat16, True, 16),
])
def test_flash_kernel_matches_plain(b, h, kh, s, d, dtype, causal, window):
    rng = np.random.default_rng(s + d)

    def draw(heads):
        return torch.from_numpy(rng.standard_normal(
            (b, heads, s, d)).astype(np.float32)).to("cuda", dtype)

    q, k, v = draw(h), draw(kh), draw(kh)
    before = flash_attention_cuda.launches
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    ref = attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert out.dtype == dtype
    assert float((out.float() - ref.float()).abs().max()) <= tol
    assert torch.equal(out, flash_attention_cuda(q, k, v, causal=causal,
                                                 window=window))


def _card_model():
    cfg = dataclasses.replace(reduced(get_config("llama3.2-3b")),
                              dtype="float32")
    return cfg, M.init_params(cfg, device="cuda")


def test_dense_path_goes_through_both_kernels():
    cfg, model = _card_model()
    batch = M.synthetic_batch(cfg, ShapeSpec("t", "prefill", 40, 2),
                              device="cuda")
    n2, n3 = rms_norm_cuda.launches, flash_attention_cuda.launches
    full, _ = M.forward(cfg, model, batch)
    torch.cuda.synchronize()
    assert rms_norm_cuda.launches - n2 == 2 * cfg.num_layers + 1
    assert flash_attention_cuda.launches - n3 == cfg.num_layers
    st = M.init_decode_state(cfg, 2, 40, device="cuda")
    steps = []
    n2 = rms_norm_cuda.launches
    for t in range(40):
        steps.append(M.decode_step(cfg, model, st, batch["tokens"][:, t])[0])
    assert rms_norm_cuda.launches - n2 == 40 * (2 * cfg.num_layers + 1)
    dec = torch.stack(steps, dim=1)
    rel = float((dec - full).abs().max() / full.abs().max())
    assert rel < 5e-3


def test_serve_on_the_card():
    n2 = rms_norm_cuda.launches
    out = serve("llama3.2-3b", num_requests=4, slots=2, max_new_tokens=4)
    assert out["completed"] == 4 and out["device"].startswith("cuda")
    assert rms_norm_cuda.launches > n2
