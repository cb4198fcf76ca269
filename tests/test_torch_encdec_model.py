"""The port's enc-dec LM (seamless-m4t-medium's family) against the JAX
package on the CPU.

The reference's ``init_params`` draws the weights; ``params_from_reference``
carries them into the port, so both packages run the same model. Token ids
and the stubbed audio frames come from numpy seeds; the frames arrive as
bf16, as ``synthetic_batch`` makes them, and both packages cast them to the
model's dtype. On the CPU the port's RMSNorm and self-attention take their
kernels' plain versions (B2 and B3 on the card); cross-attention is PyTorch
ops on any device, as the reference's einsums.

The reference never writes the encoder's memory into the decode state's
``cross_k``/``cross_v``: they start as bf16 zeros and only
``reset_decode_slots`` writes them (zeros again). So decode attends to
whatever the state holds. The tests below hold decode against the
reference both on that zero memory and on a memory filled with the same
random values in both packages, so the cross-attention of decode runs on
values that reach the logits.

Tolerances, as a share of the reference's max |logits|: 1e-4 in float32,
2e-2 in bfloat16 (bf16 rounds at other places in XLA and PyTorch).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as RM
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import attention as ref_attn
from repro_torch import models as M
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models import attention as attn

ARCH = "seamless-m4t-medium"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SEQ = 32     # decoder tokens
FRAMES = 20  # encoder frames: another length than the decoder's
STEPS = 16


def _cfgs(dtype, **changes):
    changes = dict(dtype=dtype, **changes)
    return (dataclasses.replace(ref_reduced(ref_get_config(ARCH)), **changes),
            dataclasses.replace(reduced(get_config(ARCH)), **changes))


@functools.lru_cache(maxsize=None)
def _pair(dtype, **changes):
    """(ref cfg, ref params, port cfg, port model), same weights."""
    rcfg, cfg = _cfgs(dtype, **changes)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    model = M.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    "cpu")
    return rcfg, params, cfg, model


def _inputs(cfg, seed=0, seq=SEQ, frames=FRAMES, zero=False):
    """(tokens int32 (2, seq), frames float32 (2, frames, D) rounded to
    bf16) as numpy arrays."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (2, seq), dtype=np.int32)
    fr = rng.standard_normal((2, frames, cfg.d_model)).astype(np.float32)
    if zero:
        fr[:] = 0.0
    fr = torch.from_numpy(fr).to(torch.bfloat16).float().numpy()
    return tokens, fr


def _ref_batch(tokens, frames):
    return {"tokens": jnp.asarray(tokens),
            "frames": jnp.asarray(frames).astype(jnp.bfloat16)}


def _port_batch(tokens, frames):
    return {"tokens": torch.from_numpy(tokens),
            "frames": torch.from_numpy(frames).to(torch.bfloat16)}


def _rel(port, ref):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    return float(np.max(np.abs(port.float().numpy() - ref))
                 / np.max(np.abs(ref)))


def _fill_memory(rst, st, seed):
    """The same random bf16 values into both packages' cross_k/cross_v."""
    rng = np.random.default_rng(seed)
    for key in ("cross_k", "cross_v"):
        vals = rng.standard_normal(tuple(st[key].shape)).astype(np.float32)
        st[key].copy_(torch.from_numpy(vals))
        rst[key] = jnp.asarray(vals).astype(jnp.bfloat16)
    return rst


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(dtype):
    """Real frames through the encoder, cross-attention over its memory of
    another length than the decoder's tokens."""
    rcfg, params, cfg, model = _pair(dtype)
    tokens, frames = _inputs(cfg)
    ref, _ = jax.jit(functools.partial(RM.forward, rcfg))(
        params, _ref_batch(tokens, frames))
    before = flash_attention_cuda.launches
    out, aux = M.forward(cfg, model, _port_batch(tokens, frames))
    assert flash_attention_cuda.launches == before  # the CPU takes plain
    assert out.shape == (2, SEQ, cfg.padded_vocab())
    assert out.dtype == model.embedding["embed"].dtype
    assert float(aux) == 0.0
    assert _rel(out, ref) < TOL[dtype]


def test_frames_move_the_logits():
    """The encoder matters in the forward: real frames against zero frames
    move the logits far beyond the tolerance, in both packages alike."""
    rcfg, params, cfg, model = _pair("float32")
    tokens, frames = _inputs(cfg, seed=5)
    _, zeros = _inputs(cfg, seed=5, zero=True)
    real, _ = M.forward(cfg, model, _port_batch(tokens, frames))
    zero, _ = M.forward(cfg, model, _port_batch(tokens, zeros))
    moved = float((real - zero).abs().max() / zero.abs().max())
    assert moved > 100 * TOL["float32"]
    ref, _ = jax.jit(functools.partial(RM.forward, rcfg))(
        params, _ref_batch(tokens, zeros))
    assert _rel(zero, ref) < TOL["float32"]


@pytest.mark.parametrize("frames", [SEQ, 8])
def test_forward_over_other_frame_counts(frames):
    """As many frames as tokens, and fewer."""
    rcfg, params, cfg, model = _pair("float32")
    tokens, fr = _inputs(cfg, seed=frames, frames=frames)
    ref, _ = jax.jit(functools.partial(RM.forward, rcfg))(
        params, _ref_batch(tokens, fr))
    out, _ = M.forward(cfg, model, _port_batch(tokens, fr))
    assert _rel(out, ref) < TOL["float32"]


@pytest.mark.parametrize("memory", ["zeros", "filled"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_logits_and_state_match_reference(dtype, memory):
    rcfg, params, cfg, model = _pair(dtype)
    tokens, _ = _inputs(cfg, seed=1, seq=STEPS)
    step = jax.jit(functools.partial(RM.decode_step, rcfg))
    rst = RM.init_decode_state(rcfg, 2, 24)
    st = M.init_decode_state(cfg, 2, 24, device="cpu")
    if memory == "filled":
        rst = _fill_memory(rst, st, seed=9)
    cross = {key: st[key].clone() for key in ("cross_k", "cross_v")}
    ptrs = [st["self"]["k"].data_ptr(), st["self"]["v"].data_ptr()]
    worst = 0.0
    for t in range(STEPS):
        ref, rst = step(params, rst, jnp.asarray(tokens[:, t]))
        out, st = M.decode_step(cfg, model, st,
                                torch.from_numpy(tokens[:, t]))
        worst = max(worst, _rel(out, ref))
    assert worst < TOL[dtype]
    assert st["pos"].tolist() == np.asarray(rst["pos"]).tolist()
    # the self caches written in place, holding the reference's rows: bf16
    # rounds values that differ by f32 noise, one bf16 ulp, up to 2^-7 of
    # the largest
    assert [st["self"]["k"].data_ptr(), st["self"]["v"].data_ptr()] == ptrs
    for name in ("k", "v"):
        assert _rel(st["self"][name], rst["self"][name]) <= max(
            TOL[dtype], 2.0 ** -7), name
    # the memory passed through unchanged, in both packages
    for key, before in cross.items():
        assert torch.equal(st[key], before)
        np.testing.assert_array_equal(
            st[key].float().numpy(), np.asarray(rst[key].astype(jnp.float32)))


def test_decode_attends_to_the_memory():
    """A filled memory moves decode's logits away from those on the zero
    memory: decode's cross-attention reaches the logits."""
    _, _, cfg, model = _pair("float32")
    tokens = torch.from_numpy(_inputs(cfg, seed=2, seq=4)[0])
    zero = M.init_decode_state(cfg, 2, 8, device="cpu")
    filled = M.init_decode_state(cfg, 2, 8, device="cpu")
    _fill_memory({}, filled, seed=3)
    for t in range(4):
        lz = M.decode_step(cfg, model, zero, tokens[:, t])[0]
        lf = M.decode_step(cfg, model, filled, tokens[:, t])[0]
    assert float((lz - lf).abs().max() / lz.abs().max()) > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_decode_state_matches_reference(dtype):
    """Keys, shapes and dtypes: ``cross_*`` bf16 zeros whatever the
    model's dtype, and the self caches bf16 too."""
    rcfg, _, cfg, _ = _pair(dtype)
    rst = RM.init_decode_state(rcfg, 3, 10)
    st = M.init_decode_state(cfg, 3, 10, device="cpu")
    assert set(st) == set(rst) == {"pos", "self", "cross_k", "cross_v"}
    flat = {"pos": st["pos"], "cross_k": st["cross_k"],
            "cross_v": st["cross_v"], "self/k": st["self"]["k"],
            "self/v": st["self"]["v"]}
    ref_flat = {"pos": rst["pos"], "cross_k": rst["cross_k"],
                "cross_v": rst["cross_v"], "self/k": rst["self"]["k"],
                "self/v": rst["self"]["v"]}
    for name, leaf in flat.items():
        ref = ref_flat[name]
        assert tuple(leaf.shape) == ref.shape, name
        assert str(leaf.dtype).removeprefix("torch.") == str(ref.dtype), name
        assert not bool(leaf.any()), name
    assert st["cross_k"].dtype == torch.bfloat16
    assert M.decode_state_cache_keys(cfg) == ("self", "cross_k", "cross_v")


def test_reset_decode_slots_matches_reference():
    """A state whose memory was filled with the same values in both
    packages, stepped, then reset in one slot: the reset zeroes that slot's
    ``cross_*`` in place (the other slot's memory kept), restarts its
    position stream, leaves the self caches alone, and decode after it
    matches the reference's."""
    rcfg, params, cfg, model = _pair("float32")
    step = jax.jit(functools.partial(RM.decode_step, rcfg))
    rst = RM.init_decode_state(rcfg, 2, 16)
    st = M.init_decode_state(cfg, 2, 16, device="cpu")
    rst = _fill_memory(rst, st, seed=4)
    tokens, _ = _inputs(cfg, seed=6, seq=8)
    for t in range(3):
        _, rst = step(params, rst, jnp.asarray(tokens[:, t]))
        M.decode_step(cfg, model, st, torch.from_numpy(tokens[:, t]))
    ptrs = {key: st[key].data_ptr() for key in ("cross_k", "cross_v")}
    kept = st["cross_k"][:, 1].clone()
    self_k = st["self"]["k"].clone()
    mask = np.array([True, False])
    rst = RM.reset_decode_slots(rcfg, rst, jnp.asarray(mask))
    out = M.reset_decode_slots(cfg, st, mask)
    assert out is st
    assert st["pos"].tolist() == np.asarray(rst["pos"]).tolist() == [0, 3]
    for key in ("cross_k", "cross_v"):
        assert st[key].data_ptr() == ptrs[key]
        assert not bool(st[key][:, 0].any())
        np.testing.assert_array_equal(
            st[key].float().numpy(), np.asarray(rst[key].astype(jnp.float32)))
    assert torch.equal(st["cross_k"][:, 1], kept)
    assert torch.equal(st["self"]["k"], self_k)
    worst = 0.0
    for t in range(3, 8):
        ref, rst = step(params, rst, jnp.asarray(tokens[:, t]))
        got, st = M.decode_step(cfg, model, st,
                                torch.from_numpy(tokens[:, t]))
        worst = max(worst, _rel(got, ref))
    assert worst < TOL["float32"]


def test_port_forward_on_zero_frames_matches_its_own_decode():
    """The reference's own check (tests/test_arch_smoke.py, 5e-3) inside
    the port, where it is exact in kind: on zero frames the encoder's
    memory is exactly 0, as the zero memory that decode attends to."""
    _, _, cfg, model = _pair("float32")
    tokens, frames = _inputs(cfg, seed=2, seq=16, frames=16, zero=True)
    full, _ = M.forward(cfg, model, _port_batch(tokens, frames))
    st = M.init_decode_state(cfg, 2, 16, device="cpu")
    tok = torch.from_numpy(tokens)
    dec = torch.stack([M.decode_step(cfg, model, st, tok[:, t])[0]
                       for t in range(16)], dim=1)
    rel = float((dec - full).abs().max() / full.abs().max())
    assert rel < 5e-3


@pytest.mark.parametrize("mode", ["exec", "probe"])
@pytest.mark.parametrize("s,t", [(32, 20), (13, 40), (16, 16)])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_cross_attention_matches_reference(s, t, kv_heads, mode):
    """``attention(kv_x=...)`` against the reference's, queries of length
    s over a memory of length t (the reference chunks s = 32 by its
    attn_chunk of 16), with and without grouped K/V heads."""
    rcfg, params, cfg, model = _pair("float32", num_kv_heads=kv_heads)
    rng = np.random.default_rng(s * t + kv_heads)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    p_ref = jax.tree.map(lambda v: v[0], params["layers"])["xattn"]
    ref = ref_attn.attention(rcfg, p_ref, jnp.asarray(x), kv_x=jnp.asarray(
        mem), causal=False, rope=False, mode=mode)
    out = attn.attention(cfg, model.layers[0]["xattn"], torch.from_numpy(x),
                         kv_x=torch.from_numpy(mem), causal=False,
                         rope=False, mode=mode)
    assert out.shape == (2, s, cfg.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_cross_attention_takes_no_causal_mask():
    _, _, cfg, model = _pair("float32")
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="causal"):
        attn.attention(cfg, model.layers[0]["xattn"], x, kv_x=x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_decode_attention_over_memory_matches_reference(dtype, kv_heads):
    """``decode_attention(kv_memory=...)``: the bf16 memory (an f32 model
    promotes it, as JAX's einsum does), no mask, the cache returned as it
    came and nothing written."""
    rcfg, params, cfg, model = _pair(dtype, num_kv_heads=kv_heads)
    rng = np.random.default_rng(kv_heads)
    hd = cfg.resolved_head_dim
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((3, 11, kv_heads, hd)).astype(np.float32)
              for _ in range(2))
    pos = np.array([0, 4, 9], np.int32)
    p_ref = jax.tree.map(lambda v: v[0], params["layers"])["xattn"]
    jdt = jnp.dtype(dtype)
    ref, ref_cache = ref_attn.decode_attention(
        rcfg, p_ref, jnp.asarray(x).astype(jdt), {}, jnp.asarray(pos),
        kv_memory=(jnp.asarray(ck).astype(jnp.bfloat16),
                   jnp.asarray(cv).astype(jnp.bfloat16)), rope=False)
    cache = {}
    out, got = attn.decode_attention(
        cfg, model.layers[0]["xattn"],
        torch.from_numpy(x).to(getattr(torch, dtype)), cache,
        torch.from_numpy(pos),
        kv_memory=(torch.from_numpy(ck).to(torch.bfloat16),
                   torch.from_numpy(cv).to(torch.bfloat16)), rope=False)
    assert got is cache and cache == {} and ref_cache == {}
    assert out.dtype == getattr(torch, dtype)
    assert _rel(out, ref) < TOL[dtype]


def test_init_params_counts_and_layout():
    """init_params materializes exactly the params the config predicts,
    under the reference's names and shapes: the encoder split per layer,
    ``enc_norm``, ``frontend.proj`` and each decoder layer's ``ln_x`` and
    ``xattn`` (no biases in cross-attention)."""
    rcfg, params, cfg, _ = _pair("bfloat16")
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert len(model.encoder) == cfg.encoder_layers
    assert len(model.layers) == cfg.num_layers
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [k.key for k in path]
        got, shape = getattr(model, keys[0]), leaf.shape
        if keys[0] in ("layers", "encoder"):  # split per layer
            got, shape = got[0], shape[1:]
        for k in keys[1:]:
            got = got[k]
        assert tuple(got.shape) == shape, keys
    assert set(model.layers[0]["xattn"]) == {"wq", "wk", "wv", "wo"}
    assert model.frontend["proj"].dtype == torch.bfloat16
    assert model.enc_norm["scale"].dtype == torch.float32


def test_params_from_reference_checks_the_new_leaves():
    rcfg, params, cfg, _ = _pair("float32")
    tree = jax.tree.map(np.asarray, params)
    bad = dict(tree, frontend={"proj": np.ones((3, 3), np.float32)})
    with pytest.raises(ValueError, match="frontend/proj"):
        M.params_from_reference(cfg, bad, "cpu")
    bad = dict(tree, enc_norm={})
    with pytest.raises(ValueError, match="enc_norm"):
        M.params_from_reference(cfg, bad, "cpu")
    layers = dict(tree["layers"])
    del layers["ln_x"]
    with pytest.raises(ValueError, match="layers"):
        M.params_from_reference(cfg, dict(tree, layers=layers), "cpu")
