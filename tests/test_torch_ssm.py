"""The port's Mamba2 block (``repro_torch.models.ssm``) against the JAX
package's ``models/ssm.py`` on the CPU.

Inputs and parameters come from numpy seeds and go to both packages as the
same arrays; ``A_log``, ``dt_bias``, ``D`` and the conv bias are drawn too,
so no term of the block sits at its init value. The reference computes the
scan in jnp (it has no Pallas kernel), and so does the port, in PyTorch
ops. Tolerance: float32 within 1e-5 of the reference's max |y|.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config, reduced
from repro_torch.models import ssm

ARCH = "zamba2-7b"
RTOL = 1e-5


def _cfgs(**changes):
    changes = dict(dtype="float32", **changes)
    return (dataclasses.replace(ref_reduced(ref_get_config(ARCH)), **changes),
            dataclasses.replace(reduced(get_config(ARCH)), **changes))


def _params(cfg, seed=0, dt_bias=(-1.0, 1.0), a_log=(-1.0, 1.0)):
    """One Mamba layer's parameters as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    defs = ssm.mamba_defs(cfg)
    p = {k: (rng.standard_normal(d.shape) * 0.2).astype(np.float32)
         for k, d in defs.items()}
    p["A_log"] = rng.uniform(*a_log, defs["A_log"].shape).astype(np.float32)
    p["dt_bias"] = rng.uniform(*dt_bias, defs["dt_bias"].shape).astype(
        np.float32)
    p["D"] = rng.uniform(0.5, 1.5, defs["D"].shape).astype(np.float32)
    p["norm_scale"] = rng.uniform(0.5, 1.5, defs["norm_scale"].shape).astype(
        np.float32)
    return p


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel(port, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 5, 16])
def test_causal_conv_matches_reference(s, with_state):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32) \
        if with_state else None
    y_ref, new_ref = ref_ssm._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    y, new = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b),
                              None if st is None else torch.from_numpy(st))
    assert _rel(y, y_ref) <= RTOL
    np.testing.assert_array_equal(new.numpy(), np.asarray(new_ref))


def test_gated_norm_matches_reference():
    rng = np.random.default_rng(3)
    x, z = (rng.standard_normal((2, 7, 32)).astype(np.float32)
            for _ in range(2))
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    ref = ref_ssm._gated_norm(jnp.asarray(x), jnp.asarray(z),
                              jnp.asarray(scale), 1e-5)
    out = ssm._gated_norm(torch.from_numpy(x), torch.from_numpy(z),
                          torch.from_numpy(scale), 1e-5)
    assert _rel(out, ref) <= RTOL


@pytest.mark.parametrize("mode", ["exec", "probe"])
@pytest.mark.parametrize("s", [8, 32, 12])
def test_mamba_apply_matches_reference(mode, s):
    rcfg, cfg = _cfgs()
    pj, pt = _both(_params(cfg))
    x = _x((2, s, cfg.d_model), s)
    ref = ref_ssm.mamba_apply(rcfg, pj, jnp.asarray(x), mode=mode)
    out = ssm.mamba_apply(cfg, pt, torch.from_numpy(x), mode=mode)
    assert out.shape == (2, s, cfg.d_model)
    assert _rel(out, ref) <= RTOL


@pytest.mark.parametrize("chunk", [4, 8, 40, 7])
def test_forward_does_not_depend_on_ssm_chunk(chunk):
    """Chunks of 4 and 8 divide S = 40; 40 is S itself; 7 does not divide
    it, so both packages fall back to one chunk of S. Each holds the
    reference at the same chunk and the port's own result at chunk 8."""
    rcfg, cfg = _cfgs(ssm_chunk=chunk)
    _, cfg8 = _cfgs(ssm_chunk=8)
    pj, pt = _both(_params(cfg, seed=1))
    x = _x((2, 40, cfg.d_model), 5)
    ref = ref_ssm.mamba_apply(rcfg, pj, jnp.asarray(x))
    out = ssm.mamba_apply(cfg, pt, torch.from_numpy(x))
    out8 = ssm.mamba_apply(cfg8, pt, torch.from_numpy(x))
    assert _rel(out, ref) <= RTOL
    assert float((out - out8).abs().max()) <= RTOL * float(out8.abs().max())


def test_upper_triangle_overflow_stays_finite():
    """A strong dt (dt_bias near 50, A near -e) makes exp(cum_i - cum_j)
    overflow to inf above the diagonal of every chunk. Both packages drop
    those entries by selection, so the output stays finite and they
    agree."""
    rcfg, cfg = _cfgs()
    pj, pt = _both(_params(cfg, seed=2, dt_bias=(49.0, 51.0),
                           a_log=(0.9, 1.1)))
    x = _x((2, 16, cfg.d_model), 6)
    dt = 50.0 * np.e  # the order of -log_a a step
    assert dt * (cfg.ssm_chunk - 1) > np.log(np.finfo(np.float32).max)
    ref = ref_ssm.mamba_apply(rcfg, pj, jnp.asarray(x))
    out = ssm.mamba_apply(cfg, pt, torch.from_numpy(x))
    assert np.isfinite(np.asarray(ref)).all()
    assert bool(torch.isfinite(out).all())
    assert _rel(out, ref) <= RTOL


def test_mamba_decode_step_matches_reference():
    """One step from a drawn state: output, ``ssm`` (updated in place) and
    ``conv``, which the port holds in the model's dtype."""
    rcfg, cfg = _cfgs()
    pj, pt = _both(_params(cfg, seed=3))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    state = ssm.init_ssm_state(cfg, 3, device="cpu")
    s0 = rng.standard_normal(state["ssm"].shape).astype(np.float32)
    c0 = rng.standard_normal(state["conv"].shape).astype(np.float32)
    y_ref, st_ref = ref_ssm.mamba_decode_step(
        rcfg, pj, jnp.asarray(x), {"ssm": jnp.asarray(s0),
                                   "conv": jnp.asarray(c0)})
    assert state["conv"].dtype == torch.float32
    state["ssm"].copy_(torch.from_numpy(s0))
    state["conv"].copy_(torch.from_numpy(c0))
    bufs = dict(state)
    y, st = ssm.mamba_decode_step(cfg, pt, torch.from_numpy(x), state)
    assert all(st[k] is bufs[k] for k in bufs)
    assert _rel(y, y_ref) <= RTOL
    assert _rel(st["ssm"], st_ref["ssm"]) <= RTOL
    np.testing.assert_array_equal(st["conv"].numpy(),
                                  np.asarray(st_ref["conv"]))


def test_decode_steps_match_the_forward():
    """Decode, step by step from the fresh state, gives the forward's
    output: the recurrence and the chunked scan are one function."""
    _, cfg = _cfgs()
    _, pt = _both(_params(cfg, seed=5))
    x = torch.from_numpy(_x((2, 24, cfg.d_model), 7))
    full = ssm.mamba_apply(cfg, pt, x)
    state = ssm.init_ssm_state(cfg, 2, device="cpu")
    steps = torch.cat([ssm.mamba_decode_step(cfg, pt, x[:, t:t + 1],
                                             state)[0]
                       for t in range(24)], dim=1)
    assert float((steps - full).abs().max()) <= RTOL * float(
        full.abs().max())


def test_init_ssm_state_layout():
    rcfg, cfg = _cfgs()
    ref = ref_ssm.init_ssm_state(rcfg, 3)
    for dtype in ("float32", "bfloat16"):
        st = ssm.init_ssm_state(dataclasses.replace(cfg, dtype=dtype), 3,
                                device="cpu")
        assert set(st) == set(ref)
        for k, leaf in st.items():
            assert tuple(leaf.shape) == ref[k].shape and not leaf.any()
        assert st["ssm"].dtype == torch.float32
        assert st["conv"].dtype == getattr(torch, dtype)
