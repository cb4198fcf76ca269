"""The port's RMSNorm (kernel B2's plain version on the CPU) against the JAX
package: its jnp oracle and its Pallas kernel in interpret mode. Inputs come
from a numpy seed. f32 agrees to 1e-6 relative (only the order of the sum
of squares differs); bf16 to one bf16 ulp of |y| (the f32 results round to
neighbouring bf16 values where they fall near a rounding boundary). The
kernel itself is held against this plain version on the card in
``test_torch_dense_card.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.kernel import rms_norm_pallas
from repro.kernels.rmsnorm.ref import rms_norm_ref as jax_rms_norm_ref
from repro_torch.kernels.rmsnorm import rms_norm, rms_norm_cuda, rms_norm_ref

SHAPES = [(4, 64), (2, 3, 128), (37, 5632), (2, 8, 3072)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    return x, scale


def _bf16_ulp(y):
    """One bf16 ulp at |y| (8 significant bits)."""
    mag = np.maximum(np.abs(y), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("shape", SHAPES)
def test_f32_matches_oracle_and_pallas(shape):
    x, scale = _inputs(shape, 0)
    out = rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy()
    oracle = np.asarray(jax_rms_norm_ref(jnp.asarray(x), jnp.asarray(scale)))
    pallas = np.asarray(rms_norm_pallas(jnp.asarray(x), jnp.asarray(scale),
                                        interpret=True))
    np.testing.assert_allclose(out, oracle, rtol=1e-6, atol=0)
    np.testing.assert_allclose(out, pallas, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_within_one_ulp(shape):
    x, scale = _inputs(shape, 1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = rms_norm(xb, torch.from_numpy(scale))
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    for ref in (jax_rms_norm_ref(xj, jnp.asarray(scale)),
                rms_norm_pallas(xj, jnp.asarray(scale), interpret=True)):
        ref = np.asarray(ref.astype(jnp.float32))
        assert np.all(np.abs(out - ref) <= _bf16_ulp(ref))


def test_eps():
    x, scale = _inputs((3, 64), 2)
    xt, st = torch.from_numpy(x * 1e-3), torch.from_numpy(scale)
    for eps in (1e-5, 1e-2):
        want = np.asarray(jax_rms_norm_ref(jnp.asarray(x * 1e-3),
                                           jnp.asarray(scale), eps=eps))
        np.testing.assert_allclose(rms_norm(xt, st, eps=eps).numpy(), want,
                                   rtol=1e-6)
        assert torch.equal(rms_norm(xt, st, eps=eps),
                           rms_norm_ref(xt, st, eps=eps))


def test_cpu_tensors_launch_nothing():
    x, scale = _inputs((5, 64), 3)
    before = rms_norm_cuda.launches
    rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    assert rms_norm_cuda.launches == before


@pytest.mark.parametrize("x,scale,exc", [
    (torch.zeros(2, 64, device="meta"), torch.ones(64, device="meta"),
     ValueError),
    (torch.zeros(2, 64, dtype=torch.float16), torch.ones(64), TypeError),
    (torch.zeros(2, 64), torch.ones(64, dtype=torch.bfloat16), TypeError),
    (torch.zeros(2, 64), torch.ones(32), ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(x, scale, exc):
    with pytest.raises(exc):
        rms_norm_cuda(x, scale)
