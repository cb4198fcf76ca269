"""The port's flash attention (kernel B3's plain version on the CPU) against
the JAX package: its jnp oracle and its Pallas kernel in interpret mode
(16x16 blocks). Inputs come from a numpy seed. Tolerances are the JAX
package's own (``tests/test_kernels.py``): 2e-5 for f32, 3e-2 for bf16.
Ragged lengths and grouped K/V heads, which the Pallas wrapper does not
take, are held against the oracle alone. The kernel itself is held against
this plain version on the card in ``test_torch_dense_card.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro_torch.kernels.flash_attention import (
    attention_ref, flash_attention, flash_attention_cuda,
)

MASKS = [(True, 0), (True, 16), (False, 0)]


def _qkv(shape, seed, kv_heads=None):
    b, h, s, d = shape
    rng = np.random.default_rng(seed)
    kshape = (b, kv_heads or h, s, d)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(kshape).astype(np.float32),
            rng.standard_normal(kshape).astype(np.float32))


def _port(q, k, v, dtype=torch.float32, **kw):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return flash_attention(*t, **kw).float().numpy()


@pytest.mark.parametrize("shape", [(1, 1, 32, 8), (2, 3, 64, 16),
                                   (1, 2, 128, 32)])
@pytest.mark.parametrize("causal,window", MASKS)
def test_f32_matches_oracle_and_pallas(shape, causal, window):
    q, k, v = _qkv(shape, sum(shape))
    out = _port(q, k, v, causal=causal, window=window)
    qj, kj, vj = (jnp.asarray(a) for a in (q, k, v))
    oracle = jax_attention(qj, kj, vj, causal=causal, window=window)
    pallas = flash_attention_pallas(qj, kj, vj, causal=causal, window=window,
                                    block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(out, np.asarray(oracle), atol=2e-5, rtol=0)
    np.testing.assert_allclose(out, np.asarray(pallas), atol=2e-5, rtol=0)


@pytest.mark.parametrize("causal,window", MASKS)
def test_bf16_matches_oracle_and_pallas(causal, window):
    q, k, v = _qkv((2, 2, 64, 16), 7)
    out = _port(q, k, v, torch.bfloat16, causal=causal, window=window)
    qj, kj, vj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    oracle = jax_attention(qj, kj, vj, causal=causal, window=window)
    pallas = flash_attention_pallas(qj, kj, vj, causal=causal, window=window,
                                    block_q=16, block_k=16, interpret=True)
    for ref in (oracle, pallas):
        np.testing.assert_allclose(out, np.asarray(ref.astype(jnp.float32)),
                                   atol=3e-2, rtol=0)


@pytest.mark.parametrize("shape", [(1, 4, 37, 16), (2, 2, 50, 64),
                                   (1, 1, 333, 16)])
@pytest.mark.parametrize("causal,window", MASKS)
def test_ragged_lengths_match_oracle(shape, causal, window):
    q, k, v = _qkv(shape, shape[2])
    out = _port(q, k, v, causal=causal, window=window)
    ref = jax_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                        window=window)
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5, rtol=0)


@pytest.mark.parametrize("kv_heads", [1, 2])
def test_grouped_kv_heads_match_repeated_oracle(kv_heads):
    """K/V with fewer heads serve H/K consecutive query heads each, as the
    reference's _repeat_kv lays them out."""
    q, k, v = _qkv((2, 4, 24, 16), 11 + kv_heads, kv_heads=kv_heads)
    out = _port(q, k, v, causal=True, window=8)
    rep = [jnp.repeat(jnp.asarray(a), 4 // kv_heads, axis=1) for a in (k, v)]
    ref = jax_attention(jnp.asarray(q), *rep, causal=True, window=8)
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5, rtol=0)


def test_cpu_tensors_launch_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 16, 16), 5))
    before = flash_attention_cuda.launches
    assert torch.equal(flash_attention(q, k, v), attention_ref(q, k, v))
    assert flash_attention_cuda.launches == before


def _meta(*shape):
    return torch.zeros(shape, device="meta")


@pytest.mark.parametrize("args,exc", [
    ((_meta(1, 2, 16, 16),) * 3, ValueError),
    ((torch.zeros(1, 2, 16, 16), torch.zeros(1, 3, 16, 16),
      torch.zeros(1, 3, 16, 16)), ValueError),
    ((torch.zeros(1, 2, 16, 16), torch.zeros(1, 2, 8, 16),
      torch.zeros(1, 2, 8, 16)), ValueError),
    ((torch.zeros(1, 2, 16, 16), torch.zeros(1, 2, 16, 16,
                                             dtype=torch.bfloat16),
      torch.zeros(1, 2, 16, 16)), TypeError),
    ((torch.zeros(2, 16, 16),) * 3, ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(args, exc):
    with pytest.raises(exc):
        flash_attention_cuda(*args)
