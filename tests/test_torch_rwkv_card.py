"""Kernel B4 (WKV6) on the card against its plain PyTorch version, and the
RWKV path through it. These need a CUDA card and skip elsewhere; the file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rwkv_card.py

Tolerance: out within 1e-5 of max |out| and the final state within 1e-5 of
max |state|. The plain version in f32 sits within 1e-6 of a float64 scan at
the smoke's shapes, weak and strong decays included, and the kernel differs
from it only by the order of its sums.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import models as M
from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.kernels.rmsnorm import rms_norm_cuda
from repro_torch.kernels.wkv import wkv_cuda, wkv_ref
from repro_torch.launch.serve import serve

pytestmark = pytest.mark.cuda
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(b, h, s, d, lw_range, seed, state=False, layout="bhsd"):
    rng = np.random.default_rng(seed)

    def draw(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).cuda()

    if layout == "bhsd":
        r, k, v = (draw((b, h, s, d), 0.5) for _ in range(3))
        lw = torch.from_numpy(rng.uniform(*lw_range, (b, h, s, d)).astype(
            np.float32)).cuda()
    else:  # views of (B, S, H, D) products, as the model hands them over
        r, k, v = (draw((b, s, h, d), 0.5).transpose(1, 2) for _ in range(3))
        lw = torch.from_numpy(rng.uniform(*lw_range, (b, s, h, d)).astype(
            np.float32)).cuda().transpose(1, 2)
    u = draw((h, d), 0.5)
    st = draw((b, h, d, d)) if state else None
    return r, k, v, lw, u, st


def _close(got, ref):
    return float((got - ref).abs().max()) <= RTOL * float(ref.abs().max())


@pytest.mark.parametrize("b,h,s,d,lw_range,state,layout", [
    (1, 1, 32, 16, (-1.6, -0.1), False, "bhsd"),
    (2, 2, 64, 16, (-1.6, -0.1), True, "bhsd"),
    (1, 2, 128, 16, (-1.6, -0.1), False, "bsh"),
    (2, 4, 333, 64, (-1.6, -0.6), True, "bsh"),
    (1, 3, 100, 64, (-0.01, 0.0), False, "bhsd"),
    (1, 2, 77, 64, (-20.0, 0.0), True, "bhsd"),
    (8, 32, 1, 64, (-1.6, -0.6), True, "bsh"),
])
def test_wkv_kernel_matches_plain(b, h, s, d, lw_range, state, layout):
    r, k, v, lw, u, st = _inputs(b, h, s, d, lw_range, s + d, state, layout)

    def run():  # a given state is updated in place: hand over a copy
        return wkv_cuda(r, k, v, lw, u, None if st is None else st.clone())

    before = wkv_cuda.launches
    out, final = run()
    torch.cuda.synchronize()
    assert wkv_cuda.launches == before + 1
    ref, ref_final = wkv_ref(r, k, v, lw, u, st)
    assert out.shape == (b, h, s, d) and final.shape == (b, h, d, d)
    assert _close(out, ref) and _close(final, ref_final)
    again, _ = run()
    assert torch.equal(out, again)  # repeats bit for bit


def test_wkv_kernel_updates_its_state_in_place():
    r, k, v, lw, u, st = _inputs(8, 32, 1, 64, (-1.6, -0.6), 7, True)
    ref, ref_final = wkv_ref(r, k, v, lw, u, st)
    buf = st.clone()
    out, final = wkv_cuda(r, k, v, lw, u, buf)
    torch.cuda.synchronize()
    assert final.data_ptr() == buf.data_ptr()
    assert _close(out, ref) and _close(buf, ref_final)


def test_wkv_kernel_refuses_what_it_does_not_take():
    r, k, v, lw, u, _ = _inputs(1, 2, 8, 16, (-1.0, -0.5), 0)
    with pytest.raises(TypeError):
        wkv_cuda(r.double(), k, v, lw, u)
    with pytest.raises(ValueError):
        wkv_cuda(r[..., :12], k[..., :12], v[..., :12], lw[..., :12],
                 u[:, :12])


def _card_model(**changes):
    cfg = dataclasses.replace(reduced(get_config("rwkv6-1.6b")),
                              dtype="float32", **changes)
    return cfg, M.init_params(cfg, device="cuda")


def test_rwkv_path_goes_through_both_kernels():
    cfg, model = _card_model()
    batch = M.synthetic_batch(cfg, ShapeSpec("t", "prefill", 40, 2),
                              device="cuda")
    n2, n4 = rms_norm_cuda.launches, wkv_cuda.launches
    full, _ = M.forward(cfg, model, batch)
    torch.cuda.synchronize()
    assert rms_norm_cuda.launches - n2 == 2 * cfg.num_layers + 1
    assert wkv_cuda.launches - n4 == cfg.num_layers
    st = M.init_decode_state(cfg, 2, 40, device="cuda")
    steps = []
    n2, n4 = rms_norm_cuda.launches, wkv_cuda.launches
    for t in range(40):
        steps.append(M.decode_step(cfg, model, st, batch["tokens"][:, t])[0])
    assert rms_norm_cuda.launches - n2 == 40 * (2 * cfg.num_layers + 1)
    assert wkv_cuda.launches - n4 == 40 * cfg.num_layers
    dec = torch.stack(steps, dim=1)
    rel = float((dec - full).abs().max() / full.abs().max())
    assert rel < 5e-3


def test_rwkv_forward_matches_plain_wkv_inside_the_model():
    from repro_torch.models import rwkv as rwkv_mod

    cfg, model = _card_model()
    batch = M.synthetic_batch(cfg, ShapeSpec("t", "prefill", 64, 2),
                              device="cuda")
    full, _ = M.forward(cfg, model, batch)
    kernel_wkv = rwkv_mod.wkv

    def plain(r, k, v, lw, u, *, state=None, chunk=64):
        out, final = wkv_ref(r, k, v, lw, u, state)
        return out, final if state is None else state.copy_(final)

    rwkv_mod.wkv = plain
    try:
        plain, _ = M.forward(cfg, model, batch)
    finally:
        rwkv_mod.wkv = kernel_wkv
    assert float((full - plain).abs().max()) <= 1e-4 * float(
        plain.abs().max())


def test_serve_rwkv_on_the_card():
    n4 = wkv_cuda.launches
    out = serve("rwkv6-1.6b", num_requests=4, slots=2, max_new_tokens=4)
    assert out["completed"] == 4 and out["device"].startswith("cuda")
    assert wkv_cuda.launches - n4 == 2 * out["steps"]  # 2 reduced layers
