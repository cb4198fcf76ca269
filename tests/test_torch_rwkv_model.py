"""The port's RWKV6 LM against the JAX package on the CPU.

The reference's ``init_params`` draws the weights; ``params_from_reference``
carries them into the port, so both packages run the same model. Token ids
come from numpy seeds. On the CPU the port's RMSNorm and WKV take their
kernels' plain versions (B2 and B4 on the card).

Random init leaves ``mu``, ``mu_c``, ``bonus_u`` and ``decay_base`` at zero
(no token shift, no bonus, log-decays near -1, which forget within a few
tokens). The "shifted" weights draw the shifts and the bonus from a numpy
seed and move ``decay_base`` to -4 (w near 0.98), so tokens far back
matter and every term of the block is exercised.

Tolerances, as a share of the reference's max |logits|: 1e-4 in float32,
2e-2 in bfloat16. The reference runs its chunked WKV at the reduced
config's ``ssm_chunk`` of 8, where it is finite (see
``test_forward_does_not_depend_on_ssm_chunk``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as RM
from repro.models import rwkv as ref_rwkv
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro_torch import models as M
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.wkv import wkv_cuda
from repro_torch.models import rwkv
from repro_torch.models.transformer import decode_state_cache_keys

ARCH = "rwkv6-1.6b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SEQ = 32
STEPS = 16


def _cfgs(dtype, **changes):
    changes = dict(dtype=dtype, **changes)
    return (dataclasses.replace(ref_reduced(ref_get_config(ARCH)), **changes),
            dataclasses.replace(reduced(get_config(ARCH)), **changes))


def _shift(params):
    """Token shifts, bonus and ln_wkv from a numpy seed; decay_base -4."""
    rng = np.random.default_rng(7)
    tm = dict(params["layers"]["tm"])

    def like(name, draw):
        return jnp.asarray(draw(tm[name].shape).astype(np.float32)).astype(
            tm[name].dtype)

    tm["mu"] = like("mu", lambda s: rng.uniform(0, 1, s))
    tm["mu_c"] = like("mu_c", lambda s: rng.uniform(0, 1, s))
    tm["bonus_u"] = like("bonus_u", lambda s: rng.standard_normal(s) * 0.5)
    tm["ln_wkv"] = like("ln_wkv", lambda s: rng.uniform(0.5, 1.5, s))
    tm["decay_base"] = like("decay_base",
                            lambda s: rng.uniform(-4.5, -3.5, s))
    return dict(params, layers=dict(params["layers"], tm=tm))


@functools.lru_cache(maxsize=None)
def _pair(dtype, shifted=False, ssm_chunk=8):
    """(ref cfg, ref params, port cfg, port model), same weights."""
    rcfg, cfg = _cfgs(dtype, ssm_chunk=ssm_chunk)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    if shifted:
        params = _shift(params)
    model = M.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    "cpu")
    return rcfg, params, cfg, model


def _tokens(cfg, seed=0, shape=(2, SEQ)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def _rel(port, ref):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    return float(np.max(np.abs(port.float().numpy() - ref))
                 / np.max(np.abs(ref)))


def _ref_forward(rcfg, params, tokens):
    out, _ = jax.jit(functools.partial(RM.forward, rcfg))(
        params, {"tokens": jnp.asarray(tokens)})
    return out


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(dtype, shifted):
    rcfg, params, cfg, model = _pair(dtype, shifted)
    tokens = _tokens(cfg)
    ref = _ref_forward(rcfg, params, tokens)
    before = wkv_cuda.launches
    out, aux = M.forward(cfg, model, {"tokens": torch.from_numpy(tokens)})
    assert wkv_cuda.launches == before  # the CPU takes the plain version
    assert out.shape == (2, SEQ, cfg.padded_vocab())
    assert out.dtype == model.embedding["embed"].dtype
    assert float(aux) == 0.0
    assert _rel(out, ref) < TOL[dtype]


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_logits_and_state_match_reference(dtype, shifted):
    rcfg, params, cfg, model = _pair(dtype, shifted)
    tokens = _tokens(cfg, seed=1, shape=(2, STEPS))
    step = jax.jit(functools.partial(RM.decode_step, rcfg))
    rst = RM.init_decode_state(rcfg, 2, 24)
    st = M.init_decode_state(cfg, 2, 24, device="cpu")
    leaves = {k: v.data_ptr() for k, v in st["rwkv"].items()}
    worst = 0.0
    for t in range(STEPS):
        ref, rst = step(params, rst, jnp.asarray(tokens[:, t]))
        out, st = M.decode_step(cfg, model, st,
                                torch.from_numpy(tokens[:, t]))
        worst = max(worst, _rel(out, ref))
    assert worst < TOL[dtype]
    assert st["pos"].tolist() == np.asarray(rst["pos"]).tolist()
    # updated in place, in the reference's dtypes and within tolerance; the
    # bf16 leaves (tm_x, cm_x) round values that differ by f32 noise, so an
    # element may land one bf16 ulp away: up to 2^-7 of the largest
    assert {k: v.data_ptr() for k, v in st["rwkv"].items()} == leaves
    for name, leaf in st["rwkv"].items():
        ref_leaf = rst["rwkv"][name]
        assert str(leaf.dtype).removeprefix("torch.") == str(ref_leaf.dtype)
        tol = TOL[dtype] if leaf.dtype == torch.float32 else max(
            TOL[dtype], 2.0 ** -7)
        assert _rel(leaf, ref_leaf) <= tol


@pytest.mark.parametrize("shifted", [False, True])
def test_port_forward_matches_its_own_decode(shifted):
    """The reference's own check (tests/test_arch_smoke.py), inside the
    port: teacher-forced decode logits against the full-sequence forward."""
    _, _, cfg, model = _pair("float32", shifted)
    tokens = torch.from_numpy(_tokens(cfg, seed=2, shape=(2, 16)))
    full, _ = M.forward(cfg, model, {"tokens": tokens})
    st = M.init_decode_state(cfg, 2, 16, device="cpu")
    dec = torch.stack([M.decode_step(cfg, model, st, tokens[:, t])[0]
                       for t in range(16)], dim=1)
    rel = float((dec - full).abs().max() / full.abs().max())
    assert rel < 5e-3


@pytest.mark.parametrize("leaf", ["wkv", "tm_x", "cm_x"])
def test_decode_that_drops_a_carried_leaf_is_far_off(leaf):
    """The forward-vs-decode check catches a state not carried: with one
    leaf zeroed before every step the gap is at least ten times the 5e-3
    that ``test_port_forward_matches_its_own_decode`` allows."""
    _, _, cfg, model = _pair("float32", True)
    tokens = torch.from_numpy(_tokens(cfg, seed=2, shape=(2, 16)))
    full, _ = M.forward(cfg, model, {"tokens": tokens})
    st = M.init_decode_state(cfg, 2, 16, device="cpu")
    steps = []
    for t in range(16):
        st["rwkv"][leaf].zero_()
        steps.append(M.decode_step(cfg, model, st, tokens[:, t])[0])
    rel = float((torch.stack(steps, dim=1) - full).abs().max()
                / full.abs().max())
    assert rel > 5e-2


def test_reset_decode_slots_isolates_streams():
    """Resetting one slot restarts its stream exactly (logits match a fresh
    state) while its neighbour's stream is untouched: the recurrent family
    is the hard case, since its history lives in the state."""
    _, _, cfg, model = _pair("float32", True)

    def step(state, toks):
        return M.decode_step(cfg, model, state,
                             torch.tensor(toks, dtype=torch.int32))[0]

    st = M.init_decode_state(cfg, 2, 16, device="cpu")
    cont = M.init_decode_state(cfg, 2, 16, device="cpu")
    for t in (3, 5, 7):
        step(st, [t, t + 1])
        step(cont, [t, t + 1])
    M.reset_decode_slots(cfg, st, np.array([True, False]))
    assert st["pos"].tolist() == [0, 3]
    for leaf in st["rwkv"].values():
        assert not leaf[:, 0].any() and leaf[:, 1].any()
    fresh = M.init_decode_state(cfg, 2, 16, device="cpu")
    for t in (2, 4):
        la, lf, lc = step(st, [t, 9]), step(fresh, [t, 0]), step(cont,
                                                                 [t, 9])
        torch.testing.assert_close(la[0], lf[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(la[1], lc[1], rtol=1e-5, atol=1e-5)


def test_init_params_counts_and_layout():
    """init_params materializes exactly the params the config predicts,
    under the reference's names, shapes and dtypes."""
    rcfg, params, cfg, _ = _pair("bfloat16")
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    ref = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in ref:
        keys = [k.key for k in path]
        if keys[0] == "layers":
            got = model.layers[0]
            for k in keys[1:]:
                got = got[k]
            assert tuple(got.shape) == leaf.shape[1:], keys
            assert str(got.dtype).removeprefix("torch.") == str(leaf.dtype)
        else:
            assert tuple(model.get_submodule(keys[0])[keys[1]].shape) \
                == leaf.shape, keys
    tm = model.layers[0]["tm"]
    assert set(model.layers[0]) == {"ln1", "tm", "ln2"}
    for name in ("decay_base", "bonus_u", "ln_wkv"):
        assert tm[name].dtype == torch.float32
    assert tm["w_r"].dtype == torch.bfloat16
    assert "unembed" in model.embedding  # rwkv6 does not tie


def test_decode_state_layout():
    _, _, cfg, _ = _pair("float32")
    st = M.init_decode_state(cfg, 3, 8, device="cpu")
    rst = RM.init_decode_state(_cfgs("float32")[0], 3, 8)
    assert set(st) == set(rst) == {"pos", "rwkv"}
    for name, leaf in st["rwkv"].items():
        assert tuple(leaf.shape) == rst["rwkv"][name].shape
        assert str(leaf.dtype).removeprefix("torch.") == str(
            rst["rwkv"][name].dtype)
    assert decode_state_cache_keys(cfg) == ()


def test_forward_does_not_depend_on_ssm_chunk():
    """The reference's chunked WKV overflows at its default ssm_chunk of
    256 (exp(-cum) over a chunk's summed log-decays); the port computes the
    recurrence step by step, so it gives the reference's chunk-8 logits at
    either chunk."""
    tokens = _tokens(reduced(get_config(ARCH)), seed=3, shape=(1, 256))
    rcfg8, params, cfg8, model = _pair("float32", ssm_chunk=8)
    rcfg256, cfg256 = _cfgs("float32", ssm_chunk=256)
    ref8 = _ref_forward(rcfg8, params, tokens)
    ref256 = _ref_forward(rcfg256, params, tokens)
    assert np.isfinite(np.asarray(ref8)).all()
    assert not np.isfinite(np.asarray(ref256)).all()
    batch = {"tokens": torch.from_numpy(tokens)}
    out8, _ = M.forward(cfg8, model, batch)
    out256, _ = M.forward(cfg256, model, batch)
    assert torch.equal(out8, out256)
    assert _rel(out256, ref8) < TOL["float32"]


def test_block_decode_step_matches_reference():
    """``rwkv_decode_step``, one layer's time mix from a carried state:
    output, WKV state (updated in place) and the bf16 ``tm_x``."""
    rcfg, params, cfg, model = _pair("float32", True)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    wkv0 = rng.standard_normal((3, cfg.rwkv_heads, cfg.rwkv_head_size,
                                cfg.rwkv_head_size)).astype(np.float32)
    last = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
    ref_state = {"wkv": jnp.asarray(wkv0),
                 "tm_x": jnp.asarray(last).astype(jnp.bfloat16),
                 "cm_x": jnp.zeros((3, cfg.d_model), jnp.bfloat16)}
    p_ref = jax.tree.map(lambda t: t[0], params["layers"]["tm"])
    y_ref, st_ref = ref_rwkv.rwkv_decode_step(rcfg, p_ref, jnp.asarray(x),
                                              ref_state)
    state = rwkv.init_rwkv_state(cfg, 3, device="cpu")
    state["wkv"].copy_(torch.from_numpy(wkv0))
    state["tm_x"].copy_(torch.from_numpy(last))
    buf = state["wkv"]
    y, st = rwkv.rwkv_decode_step(cfg, model.layers[0]["tm"],
                                  torch.from_numpy(x), state)
    assert st["wkv"] is buf and st["tm_x"].dtype == torch.bfloat16
    assert _rel(y, y_ref) < TOL["float32"]
    assert _rel(st["wkv"], st_ref["wkv"]) < TOL["float32"]
    assert _rel(st["tm_x"], st_ref["tm_x"]) <= 2.0 ** -7
