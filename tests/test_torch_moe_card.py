"""The MoE path (mixtral-8x7b's family) on the card: kernel B3 at mixtral's
attention (head dim 128, GQA 4, a sliding window) against its plain PyTorch
version, and the MoE LM through B2 and B3. These need a CUDA card and skip
elsewhere; the file imports no JAX, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_card.py

Tolerances: f32 within 2e-5 absolute (the JAX package's kernel tests); bf16
within 3e-2 and, element by element, within the bound that rounding P and
o to bf16 allows against the f32 attention of the same bf16 values
(``bf16_error_bound``). The MoE's routing, dispatch and expert FFNs are
PyTorch ops, held against the plain run of the same model on the CPU.
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
from repro_torch.models import moe

pytestmark = pytest.mark.cuda
D = 128


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


# (B, H, K, S, window): mixtral's GQA 4 under windows that cut the
# sequence, at a ragged S and at a window not a multiple of the tiles
CASES = [
    (1, 32, 8, 1500, 1024),
    (2, 8, 2, 700, 300),
    (1, 4, 1, 333, 128),
    (2, 8, 2, 257, 4096),
]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,h,kh,s,window", CASES)
def test_windowed_gqa_attention_at_head_dim_128(b, h, kh, s, window, dtype):
    dtype = getattr(torch, dtype)
    q, k, v = _qkv(b, h, kh, s, dtype, s + h)
    n_tc = flash_attention_cuda.launches_tc
    out = flash_attention_cuda(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches_tc - n_tc == (dtype
                                                      == torch.bfloat16)
    ref = attention_ref(q, k, v, causal=True, window=window)
    if dtype == torch.float32:
        assert float((out - ref).abs().max()) <= 2e-5
    else:
        assert float((out.float() - ref.float()).abs().max()) <= 3e-2
        o32, bound = bf16_error_bound(q, k, v, causal=True, window=window)
        assert bool(((out.float() - o32).abs() <= bound).all())


def _moe(dtype, **changes):
    cfg = dataclasses.replace(reduced(get_config("mixtral-8x7b")),
                              dtype=dtype, **changes)
    return cfg, M.init_params(cfg, device="cuda")


def test_moe_apply_on_the_card_matches_the_cpu():
    """The same routing, drops and output on the card as on the CPU."""
    cfg, model = _moe("float32")
    p = model.layers[0]["moe"]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, cfg.d_model)) + rng.standard_normal(
        (2, 1, cfg.d_model))
    x = torch.from_numpy(x.astype(np.float32))
    p_cpu = {k: v.cpu() for k, v in p.items()}
    out, aux = moe.moe_apply(cfg, p, x.cuda())
    ref, ref_aux = moe.moe_apply(cfg, p_cpu, x)
    _, ids, _ = moe.route(cfg, p, x.cuda())
    _, ref_ids, _ = moe.route(cfg, p_cpu, x)
    assert torch.equal(ids.cpu(), ref_ids)
    _, keep = moe.dispatch_slots(ref_ids, cfg.num_experts,
                                 moe.capacity(cfg, 32))
    assert not bool(keep.all())  # this input drops choices
    assert float((out.cpu() - ref).abs().max()) <= 1e-5 * float(
        ref.abs().max())
    assert abs(float(aux) - float(ref_aux)) <= 1e-6 * float(ref_aux)


def test_moe_path_goes_through_both_kernels():
    cfg, model = _moe("float32", capacity_factor=2.0)  # E/k: no drops
    batch = M.synthetic_batch(cfg, ShapeSpec("t", "prefill", 40, 2),
                              device="cuda")
    n2, n3 = rms_norm_cuda.launches, flash_attention_cuda.launches
    full, aux = M.forward(cfg, model, batch)
    torch.cuda.synchronize()
    assert rms_norm_cuda.launches - n2 == 2 * cfg.num_layers + 1
    assert flash_attention_cuda.launches - n3 == cfg.num_layers
    assert float(aux) > 0
    st = M.init_decode_state(cfg, 2, 40, device="cuda")
    steps = []
    n2, n3 = rms_norm_cuda.launches, flash_attention_cuda.launches
    for t in range(40):
        steps.append(M.decode_step(cfg, model, st, batch["tokens"][:, t])[0])
    torch.cuda.synchronize()
    assert rms_norm_cuda.launches - n2 == 40 * (2 * cfg.num_layers + 1)
    assert flash_attention_cuda.launches == n3  # decode attention is torch
    dec = torch.stack(steps, dim=1)
    rel = float((dec - full).abs().max() / full.abs().max())
    assert rel < 5e-3


def test_bf16_moe_forward_goes_through_the_tensor_core_kernel():
    cfg, model = _moe("bfloat16", head_dim=D)
    batch = M.synthetic_batch(cfg, ShapeSpec("t", "prefill", 200, 2),
                              device="cuda")
    n_tc = flash_attention_cuda.launches_tc
    logits, aux = M.forward(cfg, model, batch)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches_tc - n_tc == cfg.num_layers
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))


def test_serve_moe_on_the_card():
    n2 = rms_norm_cuda.launches
    out = serve("mixtral-8x7b", num_requests=4, slots=2, max_new_tokens=4)
    assert out["completed"] == 4 and out["device"].startswith("cuda")
    assert rms_norm_cuda.launches > n2
