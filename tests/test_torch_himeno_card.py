"""Kernel B1 on the card against its plain PyTorch version, and the app
through it. These need a CUDA card and skip elsewhere; the file imports no
JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_himeno_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.apps.himeno_app import LOOP_UNITS, UNIT_NAMES, HimenoApp
from repro_torch.kernels.himeno import (
    himeno_init, himeno_run, himeno_stencil, himeno_sweep, jacobi_ref,
    state_from_reference, stencil_parts_ref,
)

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs a CUDA card"),
]

ARGS = ("p", "a", "b", "c", "bnd", "wrk1")


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


@pytest.mark.parametrize("grid,seed", [((7, 9, 17), 0), ((37, 45, 70), 1),
                                       ((3, 3, 3), 2)])
def test_sweep_kernel_matches_plain(grid, seed):
    st = state_from_reference(_random_state(grid, seed), "cuda")
    args = [st[k] for k in ARGS]
    before = himeno_sweep.launches
    p_k, g_k = himeno_sweep(*args)
    torch.cuda.synchronize()
    assert himeno_sweep.launches == before + 1
    p_r, g_r = jacobi_ref(*args)
    torch.testing.assert_close(p_k, p_r, atol=1e-5, rtol=0)
    assert float(g_k) == pytest.approx(float(g_r), rel=1e-4)


@pytest.mark.parametrize("grid,seed", [((7, 9, 17), 0), ((37, 45, 70), 1)])
def test_stencil_kernel_matches_plain(grid, seed):
    st = state_from_reference(_random_state(grid, seed), "cuda")
    args = [st[k] for k in ARGS]
    ss_k, parts_k = himeno_stencil(*args)
    ss_r, parts_r = stencil_parts_ref(*args)
    torch.testing.assert_close(ss_k, ss_r, atol=1e-5, rtol=0)
    assert float(parts_k.sum()) == pytest.approx(float(parts_r.sum()),
                                                 rel=1e-4)


def test_gosa_repeats_bit_for_bit():
    st = state_from_reference(_random_state((33, 40, 65), 5), "cuda")
    args = [st[k] for k in ARGS]
    g1 = himeno_sweep(*args)[1]
    g2 = himeno_sweep(*args)[1]
    assert torch.equal(g1, g2)


def test_run_on_card_matches_plain():
    st = himeno_init((17, 33, 65), device="cuda")
    p_k, g_k = himeno_run(st, 4)
    p_r, g_r = himeno_run(st, 4, impl="ref")
    torch.testing.assert_close(p_k, p_r, atol=1e-5, rtol=0)
    assert float(g_k) == pytest.approx(float(g_r), rel=1e-4)


def test_app_goes_through_kernel():
    app = HimenoApp(grid=(17, 17, 33), iters=3)
    cpu = app.run({u: 0 for u in UNIT_NAMES})
    before = himeno_stencil.launches
    gpu = app.run({u: int(u in LOOP_UNITS) for u in UNIT_NAMES})
    assert himeno_stencil.launches == before + 3
    for key in ("gosa", "final_residual"):
        assert gpu.detail[key] == pytest.approx(cpu.detail[key], rel=1e-4)
