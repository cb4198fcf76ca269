"""Kernel B3 at head dim 112 (zamba2-7b's shared attention) on the card
against its plain PyTorch version, and the hybrid path through B2 and B3.
These need a CUDA card and skip elsewhere; the file imports no JAX, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_hybrid_card.py

Tolerances: f32 within 2e-5 absolute (the JAX package's kernel tests); bf16
within 3e-2 and, element by element, within the bound that rounding P and
o to bf16 allows against the f32 attention of the same bf16 values
(``bf16_error_bound``). The tensor-core kernel lays D = 112 out as 128
columns whose last 16 TMA fills with zeros, so ragged S (not a multiple of
its 128-row tiles) and those columns are both exercised here.
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
from repro_torch.kernels.flash_attention.kernel import kernel_for
from repro_torch.kernels.flash_attention.ref import bf16_error_bound
from repro_torch.kernels.rmsnorm import rms_norm_cuda
from repro_torch.launch.serve import serve
from repro_torch.models.transformer import hybrid_groups

pytestmark = pytest.mark.cuda
D = 112


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _qkv(b, h, kh, s, dtype, seed):
    rng = np.random.default_rng(seed)

    def draw(heads):
        return torch.from_numpy(rng.standard_normal(
            (b, heads, s, D)).astype(np.float32)).to("cuda", dtype)

    return draw(h), draw(kh), draw(kh)


def test_head_dim_112_dispatch():
    assert kernel_for(torch.bfloat16, D) == "tensor_core"
    assert kernel_for(torch.float32, D) == "scalar"


# (B, H, K, S, causal, window): zamba2's own heads (no GQA), ragged S,
# windows, full attention, GQA and a single short tile
CASES = [
    (2, 32, 32, 2048, True, 0),
    (1, 4, 4, 333, True, 0),
    (2, 4, 2, 130, True, 0),
    (1, 4, 2, 700, True, 16),
    (2, 4, 4, 333, False, 0),
    (3, 2, 1, 100, True, 0),
]


@pytest.mark.parametrize("b,h,kh,s,causal,window", CASES)
def test_tensor_core_kernel_at_head_dim_112(b, h, kh, s, causal, window):
    q, k, v = _qkv(b, h, kh, s, torch.bfloat16, s + h)
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


@pytest.mark.parametrize("b,h,kh,s,causal,window", CASES[1:])
def test_scalar_kernel_at_head_dim_112(b, h, kh, s, causal, window):
    q, k, v = _qkv(b, h, kh, s, torch.float32, s + h)
    n_tc = flash_attention_cuda.launches_tc
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches_tc == n_tc
    ref = attention_ref(q, k, v, causal=causal, window=window)
    assert float((out - ref).abs().max()) <= 2e-5
    assert torch.equal(out, flash_attention_cuda(q, k, v, causal=causal,
                                                 window=window))


def test_head_dim_112_refuses_bad_input_on_the_card():
    """The wrapper raises on what the kernels do not take; it never falls
    back to the plain version for a CUDA tensor."""
    q, k, v = _qkv(1, 2, 2, 64, torch.bfloat16, 0)
    n = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(2, 3).contiguous().transpose(2, 3),
                             k, v)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k[..., :96].contiguous(),
                             v[..., :96].contiguous())
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
        flash_attention_cuda(flat[1:].view(q.shape), k, v)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_cuda(q[..., :104].contiguous(),
                             k[..., :104].contiguous(),
                             v[..., :104].contiguous())
    assert flash_attention_cuda.launches == n


def _hybrid(dtype, **changes):
    """The reduced zamba2 at 5 layers: two groups of 2 and a tail of 1."""
    cfg = dataclasses.replace(reduced(get_config("zamba2-7b")), dtype=dtype,
                              num_layers=5, **changes)
    return cfg, M.init_params(cfg, device="cuda")


def test_hybrid_path_goes_through_both_kernels():
    cfg, model = _hybrid("float32")
    ng, tail = hybrid_groups(cfg)
    assert (ng, tail) == (2, 1)
    batch = M.synthetic_batch(cfg, ShapeSpec("t", "prefill", 40, 2),
                              device="cuda")
    n2, n3 = rms_norm_cuda.launches, flash_attention_cuda.launches
    full, _ = M.forward(cfg, model, batch)
    torch.cuda.synchronize()
    # the shared ln of each group, each Mamba layer's ln, the final norm
    assert rms_norm_cuda.launches - n2 == ng + cfg.num_layers + 1
    assert flash_attention_cuda.launches - n3 == ng
    st = M.init_decode_state(cfg, 2, 40, device="cuda")
    steps = []
    n2, n3 = rms_norm_cuda.launches, flash_attention_cuda.launches
    for t in range(40):
        steps.append(M.decode_step(cfg, model, st, batch["tokens"][:, t])[0])
    torch.cuda.synchronize()
    assert rms_norm_cuda.launches - n2 == 40 * (ng + cfg.num_layers + 1)
    assert flash_attention_cuda.launches == n3  # decode attention is torch
    dec = torch.stack(steps, dim=1)
    rel = float((dec - full).abs().max() / full.abs().max())
    assert rel < 5e-3
    assert st["mamba"]["conv"].dtype == torch.float32


def test_bf16_hybrid_forward_goes_through_the_tensor_core_kernel():
    cfg, model = _hybrid("bfloat16", head_dim=D)
    batch = M.synthetic_batch(cfg, ShapeSpec("t", "prefill", 200, 2),
                              device="cuda")
    n_tc = flash_attention_cuda.launches_tc
    logits, _ = M.forward(cfg, model, batch)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches_tc - n_tc == hybrid_groups(cfg)[0]
    assert bool(torch.isfinite(logits).all())


def test_serve_hybrid_on_the_card():
    n2 = rms_norm_cuda.launches
    out = serve("zamba2-7b", num_requests=4, slots=2, max_new_tokens=4)
    assert out["completed"] == 4 and out["device"].startswith("cuda")
    assert rms_norm_cuda.launches > n2
