"""The port's WKV6 (kernel B4's plain version and entry point) against the
JAX package's oracle and Pallas kernel, on the CPU.

Inputs come from numpy seeds and go to both packages as the same arrays.
On the CPU the port's ``wkv`` takes the plain version (``wkv_ref``); the
kernel itself is held against it on the card
(``tests/test_torch_rwkv_card.py``).

Tolerances: the port's sequential scan against the reference's within 1e-5
of max |out| (both f32 step by step, only the order of the sums differs),
and so the chunked arithmetic of the tensor-core kernel
(``wkv_chunked_ref``), also with its products' operands rounded as the
kernel's 3xTF32 split rounds them: the card holds the kernel to the same
1e-5;
against ``wkv_pallas`` in interpret mode within 5e-5 absolute, the
reference's own bound between its chunked kernel and its oracle
(``tests/test_kernels.py``). The chunked backward's arithmetic
(``wkv_chunked_backward_ref``, with and without the 3xTF32 operand
rounding) against ``jax.vjp`` of the oracle: each of dr, dk, dv, dlw and du
within 1e-4 of its max |.|, the card's tolerance for the backward kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv.kernel import wkv_pallas
from repro.kernels.wkv.ref import wkv_ref as ref_wkv_ref
from repro_torch.kernels import wkv
from repro_torch.kernels.wkv import wkv_cuda, wkv_ref
from repro_torch.kernels.wkv.kernel import kernel_for, wkv_backward_cuda
from repro_torch.kernels.wkv.ref import (round_tf32, truncate_tf32,
                                         wkv_backward_ref,
                                         wkv_chunked_backward_ref,
                                         wkv_chunked_ref)

RTOL = 1e-5
PALLAS_ATOL = 5e-5
# the shapes of the reference's kernel test: (B, H, S, D, chunk)
REF_SHAPES = [(1, 1, 32, 8, 8), (2, 2, 64, 16, 16), (1, 2, 128, 16, 64)]


def _inputs(b, h, s, d, seed, lw=None, state=False):
    """r, k, v ~ N(0, 0.5^2); lw = -exp(N(0, 0.5^2)) unless a (lo, hi)
    range is given; u ~ N(0, 0.1^2); as the reference's kernel test."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) * 0.5
               for _ in range(3))
    if lw is None:
        lw = -np.exp(rng.standard_normal((b, h, s, d)) * 0.5)
    else:
        lw = rng.uniform(*lw, (b, h, s, d))
    u = rng.standard_normal((h, d)) * 0.1
    arrs = [r, k, v, lw.astype(np.float32), u.astype(np.float32)]
    if state:
        arrs.append(rng.standard_normal((b, h, d, d)).astype(np.float32))
    return arrs


def _port(arrs, **kw):
    return wkv(*map(torch.from_numpy, arrs[:5]), **kw)


def _reference(arrs):
    out, st = ref_wkv_ref(*map(jnp.asarray, arrs[:5]),
                          state=jnp.asarray(arrs[5]) if len(arrs) > 5
                          else None)
    return np.asarray(out), np.asarray(st)


def _close(got, ref, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return float(np.max(np.abs(got - ref))) <= rtol * float(
        np.max(np.abs(ref)))


@pytest.mark.parametrize("b,h,s,d,chunk", REF_SHAPES)
def test_plain_matches_reference_oracle(b, h, s, d, chunk):
    arrs = _inputs(b, h, s, d, seed=b + h + s)
    out, st = wkv_ref(*map(torch.from_numpy, arrs))
    ref_out, ref_st = _reference(arrs)
    assert out.dtype == torch.float32 and st.shape == (b, h, d, d)
    assert _close(out, ref_out) and _close(st, ref_st)


@pytest.mark.parametrize("b,h,s,d,chunk", REF_SHAPES)
def test_entry_matches_pallas_interpret(b, h, s, d, chunk):
    arrs = _inputs(b, h, s, d, seed=b + h + s)
    before = wkv_cuda.launches
    out, st = _port(arrs, chunk=chunk)
    assert wkv_cuda.launches == before  # CPU tensors launch nothing
    p_out, p_st = wkv_pallas(*map(jnp.asarray, arrs), chunk=chunk,
                             interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(p_out),
                               atol=PALLAS_ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(p_st),
                               atol=PALLAS_ATOL)


@pytest.mark.parametrize("s", [1, 7, 64])
def test_initial_state_matches_reference(s):
    """S = 1 with a state is the decode call."""
    arrs = _inputs(3, 2, s, 16, seed=s, state=True)
    out, st = _port(arrs, state=torch.from_numpy(arrs[5].copy()))
    ref_out, ref_st = _reference(arrs)
    assert _close(out, ref_out) and _close(st, ref_st)


def test_state_updated_in_place():
    arrs = _inputs(2, 2, 1, 16, seed=5, state=True)
    buf = torch.from_numpy(arrs[5].copy())
    out, st = _port(arrs, state=buf)
    ref_out, ref_st = _reference(arrs)
    assert st is buf
    assert _close(out, ref_out) and _close(buf, ref_st)


@pytest.mark.parametrize("lw,s", [((-0.01, 0.0), 256), ((-20.0, 0.0), 128)])
def test_weak_and_strong_decays_match_reference(lw, s):
    """Weak decays keep the state growing with t; strong ones drive exp(lw)
    to 0. Both packages' scans agree everywhere."""
    arrs = _inputs(1, 2, s, 16, seed=11, lw=lw, state=True)
    out, st = _port(arrs, state=torch.from_numpy(arrs[5].copy()))
    ref_out, ref_st = _reference(arrs)
    assert np.isfinite(out.numpy()).all()
    assert _close(out, ref_out) and _close(st, ref_st)


def test_strong_decay_where_pallas_is_not_finite():
    """The chunked Pallas form takes exp(-cum) of a chunk's summed
    log-decays and overflows; the port follows the oracle."""
    arrs = _inputs(1, 2, 128, 16, seed=12, lw=(-20.0, 0.0))
    p_out, _ = wkv_pallas(*map(jnp.asarray, arrs), chunk=64, interpret=True)
    assert not np.isfinite(np.asarray(p_out)).all()
    out, st = _port(arrs)
    ref_out, ref_st = _reference(arrs)
    assert np.isfinite(out.numpy()).all()
    assert _close(out, ref_out) and _close(st, ref_st)


def test_chunk_changes_nothing():
    arrs = _inputs(1, 2, 40, 8, seed=3)
    a, sa = _port(arrs, chunk=8)
    b, sb = _port(arrs, chunk=64)
    assert torch.equal(a, b) and torch.equal(sa, sb)
    with pytest.raises(ValueError, match="chunk"):
        _port(arrs, chunk=0)


def test_views_of_the_models_layout():
    """The model hands over (B, S, H, D) products viewed as (B, H, S, D)."""
    arrs = _inputs(2, 3, 9, 8, seed=4)
    views = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                              ).transpose(1, 2) for a in arrs[:4]]
    out, st = wkv(*views, torch.from_numpy(arrs[4]))
    ref_out, ref_st = _reference(arrs)
    assert _close(out, ref_out) and _close(st, ref_st)


def test_operands_are_checked():
    arrs = [torch.from_numpy(a) for a in _inputs(1, 2, 4, 8, seed=0)]
    r, k, v, lw, u = arrs
    with pytest.raises(ValueError, match="one shape"):
        wkv(r, k[:, :, :2], v, lw, u)
    with pytest.raises(ValueError, match="u must be"):
        wkv(r, k, v, lw, u[:1])
    with pytest.raises(ValueError, match="state must be"):
        wkv(r, k, v, lw, u, state=torch.zeros(1, 2, 8, 4))
    with pytest.raises(TypeError, match="float32"):
        wkv(r.double(), k, v, lw, u)
    with pytest.raises(ValueError, match="device"):
        wkv(*(t.to("meta") for t in arrs))


# -- the chunked arithmetic of the tensor-core kernel (wkv_chunked_ref) ----
# (B, H, S, lw range, initial state): the smoke's decays, model (-1.61,
# -0.64), weak (-0.01, 0) at S = 2048 and strong (-20, 0); S = 333 (ragged)
# and S = 64 k; with and without an initial state
MODEL_LW, WEAK_LW, STRONG_LW = (-1.61, -0.64), (-0.01, 0.0), (-20.0, 0.0)
CHUNKED_CASES = [
    (1, 2, 333, MODEL_LW, True),
    (2, 2, 128, MODEL_LW, False),
    (1, 2, 2048, WEAK_LW, True),
    (1, 2, 2048, WEAK_LW, False),
    (1, 2, 333, STRONG_LW, False),
    (1, 2, 192, STRONG_LW, True),
    (1, 1, 1, MODEL_LW, True),
]


def _smoke_inputs(b, h, s, lw, seed, state):
    """As chip_smoke.py draws them: r, k, v, u ~ N(0, 0.5^2), lw uniform
    in the range, the state ~ N(0, 1); head dim 64."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, s, 64)) * 0.5 for _ in range(3))
    arrs = [r, k, v, rng.uniform(*lw, (b, h, s, 64)),
            rng.standard_normal((h, 64)) * 0.5]
    if state:
        arrs.append(rng.standard_normal((b, h, 64, 64)))
    return [x.astype(np.float32) for x in arrs]


def _chunked(arrs, **kw):
    state = torch.from_numpy(arrs[5]) if len(arrs) > 5 else None
    return wkv_chunked_ref(*map(torch.from_numpy, arrs[:5]), state, **kw)


@pytest.mark.parametrize("b,h,s,lw,state", CHUNKED_CASES)
def test_chunked_matches_reference_oracle(b, h, s, lw, state):
    arrs = _smoke_inputs(b, h, s, lw, seed=s, state=state)
    out, st = _chunked(arrs)
    ref_out, ref_st = _reference(arrs)
    assert out.shape == (b, h, s, 64) and st.shape == (b, h, 64, 64)
    assert np.isfinite(out.numpy()).all()
    assert _close(out, ref_out) and _close(st, ref_st)


@pytest.mark.parametrize("lw", [MODEL_LW, WEAK_LW, STRONG_LW])
def test_chunked_with_tf32_split_operands(lw):
    """Every product's operands rounded as the kernel's 3xTF32 split rounds
    them (hi to nearest, lo truncated) at (1, 4, 2048, 64): the tolerance
    holds before the card is asked."""
    arrs = _smoke_inputs(1, 4, 2048, lw, seed=7, state=True)
    out, st = _chunked(arrs, tf32_split=True)
    ref_out, ref_st = _reference(arrs)
    assert _close(out, ref_out) and _close(st, ref_st)
    # the split does round: the plain f32 products differ from it
    plain, _ = _chunked(arrs)
    assert not torch.equal(out, plain)


def test_chunked_finite_where_pallas_is_not():
    """The chunked Pallas form takes exp(-cum) and overflows under strong
    decay; the port's chunked form multiplies factors in [0, 1] only."""
    arrs = _smoke_inputs(1, 2, 128, STRONG_LW, seed=12, state=False)
    p_out, _ = wkv_pallas(*map(jnp.asarray, arrs), chunk=64, interpret=True)
    assert not np.isfinite(np.asarray(p_out)).all()
    out, st = _chunked(arrs, tf32_split=True)
    ref_out, ref_st = _reference(arrs)
    assert np.isfinite(out.numpy()).all() and np.isfinite(st.numpy()).all()
    assert _close(out, ref_out) and _close(st, ref_st)


def test_chunked_leaves_the_state_alone():
    arrs = _smoke_inputs(1, 1, 70, MODEL_LW, seed=3, state=True)
    state = torch.from_numpy(arrs[5].copy())
    wkv_chunked_ref(*map(torch.from_numpy, arrs[:5]), state)
    assert torch.equal(state, torch.from_numpy(arrs[5]))


def test_tf32_rounding():
    """round_tf32 keeps 10 mantissa bits, to nearest, ties away from zero;
    truncate_tf32 drops the 13 low bits."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0], dtype=torch.float32)
    assert round_tf32(x).tolist() == [one + ulp, -(one + ulp), one,
                                      one + ulp, 3.0]
    assert truncate_tf32(x).tolist() == [one, -one, one, one, 3.0]


def test_kernel_for_picks_by_length_and_head_dim():
    assert kernel_for(2048, 64) == "tensor_core"
    assert kernel_for(64, 64) == "tensor_core"
    assert kernel_for(63, 64) == "sequential"
    assert kernel_for(1, 64) == "sequential"  # a decode step
    assert kernel_for(2048, 16) == "sequential"  # the reduced configs
    arrs = [torch.from_numpy(a) for a in _inputs(1, 2, 4, 8, seed=0)]
    with pytest.raises(ValueError, match="kernel must be"):
        wkv_cuda(*arrs, kernel="chunked")


# -- the chunked backward's arithmetic (wkv_chunked_backward_ref) ----------
GRAD_RTOL = 1e-4
# (B, H, S, lw range): the model's decays at S = 333 (not a multiple of
# 64) and 40 (below one chunk), weak at 1024 (the state grows over 16
# chunks), strong (lw down to -20) at 200
CHUNKED_GRAD_CASES = [(1, 2, 333, MODEL_LW), (1, 2, 40, MODEL_LW),
                      (1, 1, 1024, WEAK_LW), (1, 2, 200, STRONG_LW)]


def _grad_inputs(b, h, s, lw, seed):
    arrs = _smoke_inputs(b, h, s, lw, seed=seed, state=False)
    do = np.random.default_rng(seed + 1).standard_normal(
        (b, h, s, 64)).astype(np.float32)
    return arrs, do


def _jax_grads(arrs, do):
    _, vjp = jax.vjp(lambda *a: ref_wkv_ref(*a)[0], *map(jnp.asarray, arrs))
    return [np.asarray(t) for t in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("tf32_split", [False, True])
@pytest.mark.parametrize("b,h,s,lw", CHUNKED_GRAD_CASES, ids=str)
def test_chunked_backward_matches_jax_grad(b, h, s, lw, tf32_split):
    arrs, do = _grad_inputs(b, h, s, lw, seed=s)
    want = _jax_grads(arrs, do)
    got = wkv_chunked_backward_ref(*map(torch.from_numpy, arrs),
                                   torch.from_numpy(do),
                                   tf32_split=tf32_split)
    for name, a, w in zip(("r", "k", "v", "lw", "u"), got, want):
        assert a.shape == w.shape, name
        assert np.isfinite(a.numpy()).all(), name
        assert _close(a, w, GRAD_RTOL), (name, float(
            np.abs(a.numpy() - w).max() / np.abs(w).max()))


def test_chunked_backward_finite_where_pallas_is_not():
    """Under strong decay the chunked Pallas form overflows in the forward;
    the chunked backward's factors all lie in [0, 1] and its gradient
    stays finite and on the oracle's."""
    arrs, do = _grad_inputs(1, 2, 128, STRONG_LW, seed=12)
    p_out, _ = wkv_pallas(*map(jnp.asarray, arrs), chunk=64, interpret=True)
    assert not np.isfinite(np.asarray(p_out)).all()
    got = wkv_chunked_backward_ref(*map(torch.from_numpy, arrs),
                                   torch.from_numpy(do), tf32_split=True)
    for a, w in zip(got, _jax_grads(arrs, do)):
        assert np.isfinite(a.numpy()).all() and _close(a, w, GRAD_RTOL)


def test_backward_kernel_rule():
    """The backward takes ``kernel_for``'s kernel, as the forward does: the
    chunked one at head dim 64 from one chunk of tokens on (training), the
    sequential one below and at head dim 16; a CPU call takes the plain
    version and launches nothing, whichever is named."""
    assert kernel_for(2048, 64) == kernel_for(333, 64) == "tensor_core"
    assert kernel_for(40, 64) == kernel_for(2048, 16) == "sequential"
    arrs, do = _grad_inputs(1, 2, 70, MODEL_LW, seed=3)
    ins = [torch.from_numpy(a) for a in arrs] + [torch.from_numpy(do)]
    with pytest.raises(ValueError, match="kernel must be"):
        wkv_backward_cuda(*ins, kernel="chunked")
    before = (wkv_backward_cuda.launches, wkv_backward_cuda.launches_tc)
    got = wkv_backward_cuda(*ins, kernel="tensor_core")
    assert (wkv_backward_cuda.launches, wkv_backward_cuda.launches_tc) \
        == before
    for a, w in zip(got, wkv_backward_ref(*ins)):
        assert torch.equal(a, w)
