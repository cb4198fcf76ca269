"""Kernels B2 (RMSNorm) and B3 (flash attention) on the card against their
plain PyTorch versions, and the dense path through them. These need a CUDA
card and skip elsewhere; the file imports no JAX, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_dense_card.py

Tolerances: f32 within 2e-5 absolute (the JAX package's kernel tests);
bf16 RMSNorm within one bf16 ulp of |y|, bf16 attention within 3e-2. The
tensor-core B3 kernel (bf16, head dims 64 and 128) is also held, element by
element, to the bound that rounding P and o to bf16 allows against the f32
attention of the same bf16 values (``bf16_error_bound``): a dropped or
misplaced key tile passes 3e-2 at S = 2048 but not that bound.
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
from repro_torch.kernels.flash_attention.ref import bf16_error_bound
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


# (B, H, K, S, causal, window): the main path's shape, ragged S, windows,
# full attention, MQA and a single tile
TC_CASES = [
    (2, 24, 8, 2048, True, 0),
    (2, 4, 2, 130, True, 0),
    (1, 4, 2, 333, True, 0),
    (1, 4, 2, 700, True, 16),
    (1, 4, 2, 1000, True, 256),
    (2, 4, 2, 333, False, 0),
    (2, 8, 1, 500, True, 0),
    (3, 2, 1, 100, True, 0),
]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,h,kh,s,causal,window", TC_CASES)
def test_tensor_core_flash_kernel(b, h, kh, s, causal, window, d):
    rng = np.random.default_rng(s + d + h)

    def draw(heads):
        return torch.from_numpy(rng.standard_normal(
            (b, heads, s, d)).astype(np.float32)).to("cuda", torch.bfloat16)

    q, k, v = draw(h), draw(kh), draw(kh)
    n, n_tc = flash_attention_cuda.launches, flash_attention_cuda.launches_tc
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches_tc == n_tc + 1
    assert flash_attention_cuda.launches == n + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = attention_ref(q, k, v, causal=causal, window=window)
    assert float((out.float() - ref.float()).abs().max()) <= 3e-2
    o32, bound = bf16_error_bound(q, k, v, causal=causal, window=window)
    assert bool(((out.float() - o32).abs() <= bound).all())
    assert torch.equal(out, flash_attention_cuda(q, k, v, causal=causal,
                                                 window=window))


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                     (torch.float32, 64),
                                     (torch.bfloat16, 16)])
def test_scalar_flash_kernel_takes_the_rest(dtype, d):
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 64, d)).astype(
        np.float32)).to("cuda", dtype) for _ in range(3))
    n_tc = flash_attention_cuda.launches_tc
    out = flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches_tc == n_tc
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    ref = attention_ref(q, k, v)
    assert float((out.float() - ref.float()).abs().max()) <= tol


# q rows at an offset into a longer K/V (prefill's seq_inner): (B, H, K,
# Sq, Sk, D, dtype, causal, window, offsets); tile-multiple offsets (128 for
# the tensor-core kernel, 64 for the scalar one) and ragged ones
OFFSET_CASES = [
    (2, 6, 2, 256, 1024, 128, torch.bfloat16, True, 0, (0, 384, 768)),
    (1, 8, 2, 200, 700, 64, torch.bfloat16, True, 0, (0, 128, 500)),
    (1, 4, 4, 128, 1024, 128, torch.bfloat16, True, 256, (0, 512, 896)),
    (1, 4, 1, 300, 200, 64, torch.bfloat16, False, 0, (0,)),
    (2, 6, 2, 128, 512, 128, torch.float32, True, 0, (0, 192, 384)),
    (1, 4, 2, 70, 300, 16, torch.float32, True, 40, (0, 101, 230)),
]


@pytest.mark.parametrize("b,h,kh,sq,sk,d,dtype,causal,window,offsets",
                         OFFSET_CASES)
def test_flash_kernel_at_a_query_offset(b, h, kh, sq, sk, d, dtype, causal,
                                        window, offsets):
    """B3 with ``q_offset`` and Sq != Sk against its plain version (bf16
    also within the bf16 rounding bound), on the kernel ``kernel_for``
    picks; where the offset is a multiple of that kernel's query tile, the
    rows equal the whole sequence's launch bit for bit."""
    from repro_torch.kernels.flash_attention.kernel import kernel_for

    rng = np.random.default_rng(sq + sk + d)

    def draw(heads, rows):
        return torch.from_numpy(rng.standard_normal(
            (b, heads, rows, d)).astype(np.float32)).to("cuda", dtype)

    q_all, k, v = draw(h, max(sq, sk)), draw(kh, sk), draw(kh, sk)
    tc = kernel_for(dtype, d) == "tensor_core"
    whole = (flash_attention_cuda(q_all[:, :, :sk].contiguous(), k, v,
                                  causal=causal, window=window)
             if causal else None)
    for off in offsets:
        q = q_all[:, :, off:off + sq].contiguous()
        n, n_tc = (flash_attention_cuda.launches,
                   flash_attention_cuda.launches_tc)
        out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   q_offset=off)
        torch.cuda.synchronize()
        assert flash_attention_cuda.launches == n + 1
        assert flash_attention_cuda.launches_tc == n_tc + tc
        kw = dict(causal=causal, window=window, q_offset=off)
        ref = attention_ref(q, k, v, **kw)
        tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
        assert float((out.float() - ref.float()).abs().max()) <= tol, off
        if dtype == torch.bfloat16:
            o32, bound = bf16_error_bound(q, k, v, **kw)
            assert bool(((out.float() - o32).abs() <= bound).all()), off
        if causal and off % (128 if tc else 64) == 0:
            assert torch.equal(out, whole[:, :, off:off + sq]), off


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


def test_bf16_dense_forward_goes_through_the_tensor_core_kernel():
    cfg = dataclasses.replace(reduced(get_config("llama3.2-3b")),
                              head_dim=128)
    model = M.init_params(cfg, device="cuda")
    batch = M.synthetic_batch(cfg, ShapeSpec("t", "prefill", 200, 2),
                              device="cuda")
    n_tc = flash_attention_cuda.launches_tc
    logits, _ = M.forward(cfg, model, batch)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches_tc - n_tc == cfg.num_layers
    assert bool(torch.isfinite(logits).all())
