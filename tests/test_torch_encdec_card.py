"""Kernel B3 unmasked at head dim 64 (the enc-dec encoder's attention) and
at llava's prefill on the card against its plain PyTorch version, and the
enc-dec and VLM paths through B2 and B3. These need a CUDA card and skip
elsewhere; the file imports no JAX, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_encdec_card.py

Tolerances: f32 within 2e-5 absolute (the JAX package's kernel tests); bf16
within 3e-2 and, element by element, within the bound that rounding P and
o to bf16 allows against the f32 attention of the same bf16 values
(``bf16_error_bound``), which a key tile dropped or visited twice breaks.
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
from repro_torch.kernels.rmsnorm import rms_norm_cuda
from repro_torch.launch.serve import serve

pytestmark = pytest.mark.cuda
ENCDEC, VLM = "seamless-m4t-medium", "llava-next-mistral-7b"


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _qkv(b, h, kh, s, d, dtype, seed):
    rng = np.random.default_rng(seed)

    def draw(heads):
        return torch.from_numpy(rng.standard_normal(
            (b, heads, s, d)).astype(np.float32)).to("cuda", dtype)

    return draw(h), draw(kh), draw(kh)


# (B, H, K, S, D, causal): seamless's encoder, a ragged S, a short and a
# grouped one unmasked; llava's prefill (GQA 4, its 5,760 positions)
CASES = [
    (2, 16, 16, 2048, 64, False),
    (1, 16, 16, 333, 64, False),
    (2, 4, 4, 130, 64, False),
    (1, 4, 2, 700, 64, False),
    (3, 2, 1, 100, 64, False),
    (1, 8, 2, 5760, 128, True),
]


@pytest.mark.parametrize("b,h,kh,s,d,causal", CASES)
def test_tensor_core_kernel(b, h, kh, s, d, causal):
    q, k, v = _qkv(b, h, kh, s, d, torch.bfloat16, s + h)
    n_tc = flash_attention_cuda.launches_tc
    out = flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches_tc == n_tc + 1
    ref = attention_ref(q, k, v, causal=causal)
    assert float((out.float() - ref.float()).abs().max()) <= 3e-2
    o32, bound = bf16_error_bound(q, k, v, causal=causal)
    assert bool(((out.float() - o32).abs() <= bound).all())
    assert torch.equal(out, flash_attention_cuda(q, k, v, causal=causal))


@pytest.mark.parametrize("b,h,kh,s,d,causal", CASES[1:5])
def test_scalar_kernel_unmasked(b, h, kh, s, d, causal):
    q, k, v = _qkv(b, h, kh, s, d, torch.float32, s + h)
    n_tc = flash_attention_cuda.launches_tc
    out = flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches_tc == n_tc
    ref = attention_ref(q, k, v, causal=causal)
    assert float((out - ref).abs().max()) <= 2e-5


def _model(arch, dtype, **changes):
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype,
                              **changes)
    return cfg, M.init_params(cfg, device="cuda")


def test_encdec_path_goes_through_both_kernels():
    """bf16 at head dim 64: every self-attention of the encoder (unmasked)
    and the decoder (causal) on the tensor-core kernel; decode none."""
    cfg, model = _model(ENCDEC, "bfloat16", head_dim=64)
    enc, dec = cfg.encoder_layers, cfg.num_layers
    batch = M.synthetic_batch(cfg, ShapeSpec("t", "prefill", 200, 2),
                              device="cuda")
    n2, n3 = rms_norm_cuda.launches, flash_attention_cuda.launches_tc
    logits, _ = M.forward(cfg, model, batch)
    torch.cuda.synchronize()
    assert rms_norm_cuda.launches - n2 == 2 * enc + 1 + 3 * dec + 1
    assert flash_attention_cuda.launches_tc - n3 == enc + dec
    assert logits.shape == (2, 200, cfg.padded_vocab())
    assert bool(torch.isfinite(logits).all())
    st = M.init_decode_state(cfg, 2, 8, device="cuda")
    n2, n3 = rms_norm_cuda.launches, flash_attention_cuda.launches
    M.decode_step(cfg, model, st, batch["tokens"][:, 0])
    torch.cuda.synchronize()
    assert rms_norm_cuda.launches - n2 == 3 * dec + 1
    assert flash_attention_cuda.launches == n3
    assert st["cross_k"].dtype == torch.bfloat16
    assert not bool(st["cross_k"].any())


def test_encdec_zero_frame_forward_matches_its_decode():
    """f32 on the card (the scalar B3): on zero frames the encoder's memory
    is 0, as the memory decode attends to, so the reference's own 5e-3
    check holds."""
    cfg, model = _model(ENCDEC, "float32")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16), dtype=np.int32)).cuda()
    frames = torch.zeros((2, 16, cfg.d_model), dtype=torch.bfloat16,
                         device="cuda")
    full, _ = M.forward(cfg, model, {"tokens": tokens, "frames": frames})
    st = M.init_decode_state(cfg, 2, 16, device="cuda")
    dec = torch.stack([M.decode_step(cfg, model, st, tokens[:, t])[0]
                       for t in range(16)], dim=1)
    assert float((dec - full).abs().max() / full.abs().max()) < 5e-3


def test_vlm_forward_with_patches_goes_through_both_kernels():
    """bf16 at head dim 128 with GQA: the patch norm and the dense block's
    2n + 1 norms on B2, every attention on the tensor-core kernel, logits
    over the patches and the tokens."""
    cfg, model = _model(VLM, "bfloat16", head_dim=128, num_kv_heads=2)
    batch = M.synthetic_batch(cfg, ShapeSpec("t", "prefill", 300, 2),
                              device="cuda")
    n2, n3 = rms_norm_cuda.launches, flash_attention_cuda.launches_tc
    logits, _ = M.forward(cfg, model, batch)
    torch.cuda.synchronize()
    assert rms_norm_cuda.launches - n2 == 2 * cfg.num_layers + 2
    assert flash_attention_cuda.launches_tc - n3 == cfg.num_layers
    assert logits.shape == (2, 300, cfg.padded_vocab())
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_serve_on_the_card(arch):
    n2 = rms_norm_cuda.launches
    out = serve(arch, num_requests=4, slots=2, max_new_tokens=4)
    assert out["completed"] == 4 and out["device"].startswith("cuda")
    assert rms_norm_cuda.launches > n2
