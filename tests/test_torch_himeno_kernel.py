"""The port's Himeno sweep (kernel B1's plain version on the CPU) against the
JAX package: the pure-jnp oracle, the Pallas kernel in interpret mode, and
the reference app's NumPy stencil. Inputs come from the reference's
``himeno_init`` or a numpy seed. The kernel itself is held against these
plain versions on the card in ``test_torch_himeno_card.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps.himeno_app import _np_stencil
from repro.kernels.himeno.kernel import himeno_jacobi_pallas
from repro.kernels.himeno.ops import himeno_run as ref_run
from repro.kernels.himeno.ref import himeno_init as ref_init
from repro.kernels.himeno.ref import jacobi_ref as ref_jacobi
from repro_torch.kernels.himeno import (
    himeno_init, himeno_run, himeno_stencil, himeno_step, himeno_sweep,
    state_from_reference, stencil_ref,
)

ARGS = ("p", "a", "b", "c", "bnd", "wrk1")
GRIDS = [(5, 9, 17), (9, 17, 33), (17, 9, 17)]


def _np_state(st):
    return {k: np.asarray(st[k]) for k in ARGS}


def _random_state(grid, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        p=rng.uniform(size=grid).astype(f32),
        a=rng.uniform(size=(4,) + grid).astype(f32),
        b=(rng.uniform(size=(3,) + grid) * 0.1).astype(f32),
        c=rng.uniform(size=(3,) + grid).astype(f32),
        bnd=(rng.uniform(size=grid) > 0.5).astype(f32),
        wrk1=(rng.uniform(size=grid) * 0.01).astype(f32))


def _port(st):
    t = state_from_reference(st, "cpu")
    return [t[k] for k in ARGS]


@pytest.mark.parametrize("grid", GRIDS)
def test_sweep_matches_reference_oracle_and_pallas(grid):
    st = _np_state(ref_init(grid))
    p_ref, g_ref = ref_jacobi(*(jnp.asarray(st[k]) for k in ARGS))
    p_pl, g_pl = himeno_jacobi_pallas(*(jnp.asarray(st[k]) for k in ARGS),
                                      interpret=True)
    p_t, g_t = himeno_sweep(*_port(st))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_ref), atol=1e-6)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_pl), atol=1e-6)
    assert float(g_t) == pytest.approx(float(g_ref), rel=1e-4)
    assert float(g_t) == pytest.approx(float(g_pl), rel=1e-4)


@pytest.mark.parametrize("grid,seed", [((7, 9, 17), 0), ((6, 11, 19), 1)])
def test_sweep_nontrivial_coefficients(grid, seed):
    st = _random_state(grid, seed)
    p_ref, g_ref = ref_jacobi(*(jnp.asarray(st[k]) for k in ARGS))
    p_pl, g_pl = himeno_jacobi_pallas(*(jnp.asarray(st[k]) for k in ARGS),
                                      interpret=True)
    p_t, g_t = himeno_sweep(*_port(st))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_ref), atol=1e-5)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_pl), atol=1e-5)
    assert float(g_t) == pytest.approx(float(g_ref), rel=1e-4)
    assert float(g_t) == pytest.approx(float(g_pl), rel=1e-4)


@pytest.mark.parametrize("grid", GRIDS)
def test_init_matches_reference(grid):
    ours = himeno_init(grid, device="cpu")
    theirs = _np_state(ref_init(grid))
    for k in ARGS:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k])
        assert ours[k].is_contiguous()


@pytest.mark.parametrize("grid,seed", [((9, 9, 17), 0), ((6, 11, 19), 3)])
def test_stencil_entry_matches_app_numpy_stencil(grid, seed):
    st = _random_state(grid, seed)
    ss_np = _np_stencil(*(st[k] for k in ARGS))
    ss, parts = himeno_stencil(*_port(st))
    assert tuple(ss.shape) == tuple(n - 2 for n in grid)
    np.testing.assert_allclose(ss.numpy(), ss_np, atol=1e-6)
    np.testing.assert_allclose(stencil_ref(*_port(st)).numpy(), ss_np,
                               atol=1e-6)
    assert float(torch.sum(parts)) == pytest.approx(
        float(np.sum(np.square(ss_np))), rel=1e-4)


@pytest.mark.parametrize("iters", [1, 5])
def test_run_matches_reference_scan(iters):
    st = _np_state(ref_init((9, 17, 17)))
    p_ref, g_ref = ref_run({k: jnp.asarray(v) for k, v in st.items()}, iters,
                           impl="ref")
    port = state_from_reference(st, "cpu")
    p_t, g_t = himeno_run(port, iters)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_ref), atol=1e-6)
    assert float(g_t) == pytest.approx(float(g_ref), rel=1e-4)
    p_r, g_r = himeno_run(port, iters, impl="ref")
    assert torch.equal(p_r, p_t) and torch.equal(g_r, g_t)


def test_run_residual_decreases():
    port = state_from_reference(_np_state(ref_init((9, 17, 17))), "cpu")
    p, gosas = port["p"], []
    for _ in range(5):
        p, g = himeno_step(p, *(port[k] for k in ARGS[1:]))
        gosas.append(float(g))
    assert gosas[-1] < gosas[0]


def test_state_from_reference_round_trip():
    st = _random_state((5, 7, 9), 4)
    st["p"] = st["p"].astype(np.float64)  # carried across as f32
    port = state_from_reference(st, "cpu")
    for k in ARGS:
        t = port[k]
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        assert t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), st[k].astype(np.float32))
    port["p"].zero_()  # a copy: the reference arrays are not aliased
    assert st["p"].any()


def test_wrappers_check_operands():
    p, a, b, c, bnd, wrk1 = (himeno_init((5, 5, 5), device="cpu")[k]
                             for k in ARGS)
    with pytest.raises(ValueError):
        himeno_sweep(p, a[:3], b, c, bnd, wrk1)
    with pytest.raises(TypeError):
        himeno_stencil(p.double(), a, b, c, bnd, wrk1)
    with pytest.raises(ValueError):
        himeno_step(p, a, b, c, bnd, wrk1, impl="pallas")
