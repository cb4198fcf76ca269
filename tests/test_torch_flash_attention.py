"""The port's flash attention (kernel B3's plain version on the CPU) against
the JAX package: its jnp oracle and its Pallas kernel in interpret mode
(16x16 blocks). Inputs come from a numpy seed. Tolerances are the JAX
package's own (``tests/test_kernels.py``): 2e-5 for f32, 3e-2 for bf16.
Ragged lengths and grouped K/V heads, which the Pallas wrapper does not
take, are held against the oracle alone. The kernel itself is held against
this plain version on the card in ``test_torch_dense_card.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import NEG_INF
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro_torch.kernels.flash_attention import (
    attention_ref, flash_attention, flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.kernel import kernel_for

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", MASKS)
def test_head_dim_112_matches_oracle_and_pallas(causal, window, dtype):
    """zamba2-7b's head dim, which the card's kernels lay out as 128 columns
    of which 16 are zeros; the plain version computes it as it is."""
    q, k, v = _qkv((1, 2, 64, 112), 112)
    out = _port(q, k, v, dtype, causal=causal, window=window)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    oracle = jax_attention(qj, kj, vj, causal=causal, window=window)
    pallas = flash_attention_pallas(qj, kj, vj, causal=causal, window=window,
                                    block_q=16, block_k=16, interpret=True)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    for ref in (oracle, pallas):
        np.testing.assert_allclose(out, np.asarray(ref.astype(jnp.float32)),
                                   atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 2, 64, 64), (1, 3, 48, 64)])
def test_unmasked_head_dim_64_matches_oracle_and_pallas(shape, dtype):
    """The enc-dec encoder's attention: head dim 64, no mask (every key
    tile of every row), which the card's tensor-core kernel takes in
    bf16."""
    q, k, v = _qkv(shape, 64 + shape[2])
    out = _port(q, k, v, dtype, causal=False)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    oracle = jax_attention(qj, kj, vj, causal=False)
    pallas = flash_attention_pallas(qj, kj, vj, causal=False, block_q=16,
                                    block_k=16, interpret=True)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    for ref in (oracle, pallas):
        np.testing.assert_allclose(out, np.asarray(ref.astype(jnp.float32)),
                                   atol=tol, rtol=0)


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


@pytest.mark.parametrize("shape,kv_heads,causal,window", [
    ((2, 4, 24, 16), 2, True, 0),      # GQA
    ((1, 4, 37, 16), 4, True, 0),      # ragged
    ((1, 6, 50, 16), 2, True, 12),     # a window, GQA
    ((2, 3, 33, 64), 1, False, 0),     # unmasked, MQA
])
def test_return_lse_matches_logsumexp_of_the_reference_logits(
        shape, kv_heads, causal, window):
    """The forward's log-sum-exp (log2 domain) against ``jax.nn.logsumexp``
    of the reference's masked, scaled logits, K/V repeated as the
    reference's _repeat_kv lays them out; the output is the plain one."""
    q, k, v = _qkv(shape, 7, kv_heads=kv_heads)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention_cuda(tq, tk, tv, causal=causal, window=window,
                                    return_lse=True)
    assert lse.shape == shape[:3] and lse.dtype == torch.float32
    assert torch.equal(out, flash_attention_cuda(tq, tk, tv, causal=causal,
                                                 window=window))
    rep = jnp.repeat(jnp.asarray(k), shape[1] // kv_heads, axis=1)
    s = shape[2]
    logits = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), rep) \
        * shape[3] ** -0.5
    if causal:
        qi, ki = jnp.arange(s)[:, None], jnp.arange(s)[None, :]
        mask = ki <= qi
        if window:
            mask &= ki > qi - window
        logits = jnp.where(mask, logits, NEG_INF)
    want = np.asarray(jax.nn.logsumexp(logits, axis=-1))
    np.testing.assert_allclose(lse.numpy() * np.log(2.0), want, atol=2e-5,
                               rtol=0)


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
    ((torch.zeros(1, 2, 16, 16, dtype=torch.float16),) * 3, TypeError),
    ((torch.zeros(1, 2, 16, 16), torch.zeros(1, 2, 16, 8),
      torch.zeros(1, 2, 16, 8)), ValueError),
    ((torch.zeros(1, 2, 16, 16), torch.zeros(1, 2, 16, 16),
      torch.zeros(1, 1, 16, 16)), ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(args, exc):
    with pytest.raises(exc):
        flash_attention_cuda(*args)


@pytest.mark.parametrize("dtype,head_dim,kernel", [
    (torch.bfloat16, 128, "tensor_core"),  # the dense path's prefill
    (torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, 112, "tensor_core"),  # zamba2-7b's shared attention
    (torch.bfloat16, 16, "scalar"),        # the reduced configs
    (torch.float32, 128, "scalar"),        # f32 would be TF32 on the cores
    (torch.float32, 64, "scalar"),
    (torch.float32, 112, "scalar"),
    (torch.float32, 16, "scalar"),
])
def test_dispatch_rule(dtype, head_dim, kernel):
    assert kernel_for(dtype, head_dim) == kernel


def test_cpu_tensors_count_no_tensor_core_launch():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv((1, 2, 16, 64), 6))
    before = flash_attention_cuda.launches_tc
    assert torch.equal(flash_attention(q, k, v), attention_ref(q, k, v))
    assert flash_attention_cuda.launches_tc == before


# q rows at an offset into a longer K/V (prefill's seq_inner: a model
# rank's query rows against the whole sequence's K/V): (B, H, K, Sq, Sk,
# D), the offsets, causal, window
OFFSET_CASES = [
    ((1, 6, 2, 16, 64, 16), (0, 16, 48), True, 0),     # GQA 3, causal
    ((2, 8, 2, 20, 64, 16), (0, 37, 44), True, 24),    # GQA 4, a window
    ((1, 6, 2, 40, 24, 16), (0,), False, 0),           # unmasked, Sq > Sk
    ((2, 8, 2, 32, 96, 64), (0, 32, 64), True, 0),     # GQA 4, head dim 64
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,offsets,causal,window", OFFSET_CASES)
def test_query_offset_matches_the_reference_sdpa(shape, offsets, causal,
                                                  window, dtype):
    """B3's plain version, its CPU wrapper and the entry point with
    ``q_offset`` and Sq != Sk against the JAX package's ``_sdpa`` under
    ``_causal_window_mask(q_offset + arange(Sq), arange(Sk), window)``
    (K/V repeated as its ``_repeat_kv`` lays them out): f32 within 1e-5,
    bf16 within 3e-2. The rows at each offset also equal those rows of
    the whole sequence's attention, where the queries cover it."""
    from repro.models.attention import _causal_window_mask, _repeat_kv, _sdpa

    b, h, kh, sq, sk, d = shape
    rng = np.random.default_rng(sum(shape))
    q_all = rng.standard_normal((b, h, max(sk, sq), d)).astype(np.float32)
    k, v = (rng.standard_normal((b, kh, sk, d)).astype(np.float32)
            for _ in range(2))
    tdt = getattr(torch, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tol = 1e-5 if dtype == "float32" else 3e-2
    tk, tv = (torch.from_numpy(a).to(tdt) for a in (k, v))
    jk, jv = (_repeat_kv(jnp.asarray(a).astype(jdt).transpose(0, 2, 1, 3), h)
              for a in (k, v))
    for off in offsets:
        q = q_all[:, :, off:off + sq]
        tq = torch.from_numpy(np.ascontiguousarray(q)).to(tdt)
        mask = (_causal_window_mask(off + jnp.arange(sq), jnp.arange(sk),
                                    window) if causal else None)
        want = np.asarray(_sdpa(jnp.asarray(q).astype(jdt).transpose(
            0, 2, 1, 3), jk, jv, mask, d ** -0.5).astype(jnp.float32)
                          ).transpose(0, 2, 1, 3)
        kw = dict(causal=causal, window=window, q_offset=off)
        for got in (attention_ref(tq, tk, tv, **kw),
                    flash_attention_cuda(tq, tk, tv, **kw),
                    flash_attention(tq, tk, tv, **kw)):
            np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                       rtol=0)
        if causal:
            whole = attention_ref(torch.from_numpy(q_all).to(tdt), tk, tv,
                                  causal=causal, window=window)
            assert torch.equal(attention_ref(tq, tk, tv, **kw),
                               whole[:, :, off:off + sq])


def test_offsets_the_kernels_do_not_take_raise():
    """A masked call's queries must lie in the keys' sequence (q_offset +
    Sq <= Sk, q_offset >= 0); the backward takes one length at offset 0,
    so a gradient through an offset call raises there."""
    q = torch.zeros(1, 2, 16, 16)
    k = v = torch.zeros(1, 2, 32, 16)
    with pytest.raises(ValueError, match="offset 20 do not lie in k, v"):
        flash_attention_cuda(q, k, v, q_offset=20)
    with pytest.raises(ValueError, match="offset -1"):
        flash_attention_cuda(q, k, v, q_offset=-1)
    flash_attention_cuda(q, k, v, causal=False, q_offset=20)  # unmasked
    o, lse = flash_attention_cuda(q, k, v, q_offset=16, return_lse=True)
    assert lse.shape == (1, 2, 16)
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda)
    with pytest.raises(ValueError, match="one length at offset 0"):
        flash_attention_backward_cuda(q, k, v, o, lse, o, q_offset=16)
    with pytest.raises(ValueError, match="one length at offset 0"):
        flash_attention_backward_cuda(q, q, q, o, lse, o, q_offset=16)
    with pytest.raises(ValueError, match="one length at offset 0"):
        flash_attention_backward_cuda(q, k, v, o, lse, o)
    qg = q.clone().requires_grad_(True)
    out = flash_attention(qg, k, v, q_offset=16)
    with pytest.raises(ValueError, match="one length at offset 0"):
        out.sum().backward()
