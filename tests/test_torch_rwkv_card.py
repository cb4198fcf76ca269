"""Kernel B4 (WKV6) on the card against its plain PyTorch version, and the
RWKV path through it. These need a CUDA card and skip elsewhere; the file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rwkv_card.py

B4 has two kernels: the sequential one (decode, head dim 16) and the
chunked one on the tensor cores (head dim 64 with S >= 64); ``kernel_for``
picks one, ``kernel=`` forces one, and both are held to the plain version.

Tolerance: out within 1e-5 of max |out| and the final state within 1e-5 of
max |state|. The plain version in f32 sits within 1e-6 of a float64 scan at
the smoke's shapes, weak and strong decays included; the sequential kernel
differs from it only by the order of its sums, the chunked one by its
chunked arithmetic with 3xTF32 products, which the CPU tests hold to the
same 1e-5 (``tests/test_torch_wkv.py``, ``wkv_chunked_ref``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import models as M
from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.kernels.rmsnorm import rms_norm_cuda
from repro_torch.kernels.wkv import wkv_cuda, wkv_ref
from repro_torch.kernels.wkv.kernel import kernel_for
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

    before, before_tc = wkv_cuda.launches, wkv_cuda.launches_tc
    out, final = run()
    torch.cuda.synchronize()
    assert wkv_cuda.launches == before + 1
    # dispatch: the chunked kernel for head dim 64 and S >= 64 only
    assert wkv_cuda.launches_tc - before_tc == (
        kernel_for(s, d) == "tensor_core") == (d == 64 and s >= 64)
    ref, ref_final = wkv_ref(r, k, v, lw, u, st)
    assert out.shape == (b, h, s, d) and final.shape == (b, h, d, d)
    assert _close(out, ref) and _close(final, ref_final)
    again, _ = run()
    assert torch.equal(out, again)  # repeats bit for bit


# the cases of test_wkv_kernel_matches_plain at head dim 64, and more
# lengths about the chunk's edge
D64_CASES = [
    (2, 4, 333, (-1.6, -0.6), True, "bsh"),
    (1, 3, 100, (-0.01, 0.0), False, "bhsd"),
    (1, 2, 77, (-20.0, 0.0), True, "bhsd"),
    (8, 32, 1, (-1.6, -0.6), True, "bsh"),
    (1, 2, 63, (-1.6, -0.1), True, "bhsd"),
    (1, 2, 64, (-1.6, -0.1), False, "bsh"),
    (2, 3, 129, (-1.0, 0.0), True, "bsh"),
]


@pytest.mark.parametrize("kernel", ["tensor_core", "sequential"])
@pytest.mark.parametrize("b,h,s,lw_range,state,layout", D64_CASES)
def test_wkv_both_kernels_match_plain(kernel, b, h, s, lw_range, state,
                                      layout):
    """Either kernel forced at head dim 64 against the plain version: in
    place, repeating bit for bit."""
    r, k, v, lw, u, st = _inputs(b, h, s, 64, lw_range, s + 1, state, layout)
    ref, ref_final = wkv_ref(r, k, v, lw, u, st)

    def run():
        buf = None if st is None else st.clone()
        out, final = wkv_cuda(r, k, v, lw, u, buf, kernel=kernel)
        assert buf is None or final.data_ptr() == buf.data_ptr()
        return out, final

    before_tc = wkv_cuda.launches_tc
    out, final = run()
    torch.cuda.synchronize()
    assert wkv_cuda.launches_tc - before_tc == (kernel == "tensor_core")
    assert torch.isfinite(out).all()
    assert _close(out, ref) and _close(final, ref_final)
    again, again_final = run()
    assert torch.equal(out, again) and torch.equal(final, again_final)


def test_wkv_dispatch_by_length_and_head_dim():
    for s, d, tc in ((63, 64, 0), (64, 64, 1), (2048, 64, 1), (1, 64, 0),
                     (128, 16, 0)):
        r, k, v, lw, u, _ = _inputs(1, 2, s, d, (-1.0, -0.5), s)
        before = wkv_cuda.launches_tc
        wkv_cuda(r, k, v, lw, u)
        assert wkv_cuda.launches_tc - before == tc, (s, d)
    r, k, v, lw, u, _ = _inputs(1, 2, 80, 16, (-1.0, -0.5), 0)
    with pytest.raises(ValueError, match="head dim"):
        wkv_cuda(r, k, v, lw, u, kernel="tensor_core")


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


def test_rwkv_prefill_goes_through_the_tensor_core_kernel():
    """At head dim 64 the forward's WKVs take the chunked kernel, decode's
    the sequential one, and the two agree as the reduced model's do."""
    cfg, model = _card_model(d_model=128, rwkv_head_size=64)
    batch = M.synthetic_batch(cfg, ShapeSpec("t", "prefill", 96, 2),
                              device="cuda")
    n4, tc = wkv_cuda.launches, wkv_cuda.launches_tc
    full, _ = M.forward(cfg, model, batch)
    torch.cuda.synchronize()
    assert wkv_cuda.launches - n4 == cfg.num_layers
    assert wkv_cuda.launches_tc - tc == cfg.num_layers
    st = M.init_decode_state(cfg, 2, 96, device="cuda")
    tc = wkv_cuda.launches_tc
    steps = [M.decode_step(cfg, model, st, batch["tokens"][:, t])[0]
             for t in range(96)]
    assert wkv_cuda.launches_tc == tc
    dec = torch.stack(steps, dim=1)
    assert float((dec - full).abs().max() / full.abs().max()) < 5e-3


def test_serve_rwkv_on_the_card():
    n4 = wkv_cuda.launches
    out = serve("rwkv6-1.6b", num_requests=4, slots=2, max_new_tokens=4)
    assert out["completed"] == 4 and out["device"].startswith("cuda")
    assert wkv_cuda.launches - n4 == 2 * out["steps"]  # 2 reduced layers
