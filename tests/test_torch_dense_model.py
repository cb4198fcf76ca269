"""The port's dense LM against the JAX package on the CPU.

The reference's ``init_params`` draws the weights; ``params_from_reference``
carries them into the port, so both packages run the same model. The
token ids come from a numpy seed. On the CPU the port's RMSNorm and
attention take their kernels' plain versions (B2 and B3 on the card).

Tolerances, as a share of the reference's max |logits|: 1e-4 for float32
configs (only summation order differs, and the bf16 KV cache both packages
keep rounds the same values), 2e-2 for bf16 configs (bf16 rounds at other
places in XLA and PyTorch).
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
from repro.models import layers as ref_layers
from repro_torch import models as M
from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.models import attention as attn
from repro_torch.models import layers as layers
from repro_torch.models.transformer import TransformerLM

# name -> (arch, sliding window); each reduced: MHA, GQA + tied embeddings,
# MQA + gelu, qkv bias, and a ring-buffer window that 16 steps wrap twice
CASES = {
    "stablelm-1.6b": ("stablelm-1.6b", 0),
    "llama3.2-3b": ("llama3.2-3b", 0),
    "granite-20b": ("granite-20b", 0),
    "qwen1.5-110b": ("qwen1.5-110b", 0),
    "llama3.2-3b-window8": ("llama3.2-3b", 8),
}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SEQ = 32
STEPS = 16


def _cfgs(name, dtype):
    arch, window = CASES[name]
    changes = dict(dtype=dtype, sliding_window=window)
    return (dataclasses.replace(ref_reduced(ref_get_config(arch)), **changes),
            dataclasses.replace(reduced(get_config(arch)), **changes))


@functools.lru_cache(maxsize=None)
def _pair(name, dtype):
    """(ref cfg, ref params, port cfg, port model), same weights."""
    rcfg, cfg = _cfgs(name, dtype)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_forward_logits_match_reference(name, dtype):
    rcfg, params, cfg, model = _pair(name, dtype)
    tokens = _tokens(cfg)
    ref, _ = jax.jit(functools.partial(RM.forward, rcfg))(
        params, {"tokens": jnp.asarray(tokens)})
    out, aux = M.forward(cfg, model, {"tokens": torch.from_numpy(tokens)})
    assert out.shape == (2, SEQ, cfg.padded_vocab())
    assert out.dtype == model.embedding["embed"].dtype
    assert float(aux) == 0.0
    assert _rel(out, ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_decode_logits_match_reference(name, dtype):
    rcfg, params, cfg, model = _pair(name, dtype)
    tokens = _tokens(cfg, seed=1, shape=(2, STEPS))
    step = jax.jit(functools.partial(RM.decode_step, rcfg))
    rst = RM.init_decode_state(rcfg, 2, 24)
    st = M.init_decode_state(cfg, 2, 24, device="cpu")
    worst = 0.0
    for t in range(STEPS):
        ref, rst = step(params, rst, jnp.asarray(tokens[:, t]))
        out, st = M.decode_step(cfg, model, st,
                                torch.from_numpy(tokens[:, t]))
        worst = max(worst, _rel(out, ref))
    assert worst < TOL[dtype]
    assert st["pos"].tolist() == np.asarray(rst["pos"]).tolist()
    # the caches hold the same rows (bf16 in both packages)
    np.testing.assert_allclose(
        st["kv"]["k"].float().numpy(),
        np.asarray(rst["kv"]["k"].astype(jnp.float32)),
        atol=TOL[dtype] * 10, rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_port_forward_matches_its_own_decode(name):
    """The reference's own check (tests/test_arch_smoke.py), inside the
    port: teacher-forced decode logits against the full-sequence forward."""
    _, _, cfg, model = _pair(name, "float32")
    tokens = torch.from_numpy(_tokens(cfg, seed=2, shape=(2, 16)))
    full, _ = M.forward(cfg, model, {"tokens": tokens})
    st = M.init_decode_state(cfg, 2, 16, device="cpu")
    dec = torch.stack([M.decode_step(cfg, model, st, tokens[:, t])[0]
                       for t in range(16)], dim=1)
    rel = float((dec - full).abs().max() / full.abs().max())
    assert rel < 5e-3


def test_reset_decode_slots_isolates_streams():
    """Resetting one slot restarts its stream exactly (logits match a fresh
    state) while its neighbour's stream is untouched."""
    _, _, cfg, model = _pair("llama3.2-3b", "float32")

    def step(state, toks):
        return M.decode_step(cfg, model, state,
                             torch.tensor(toks, dtype=torch.int32))[0]

    st = M.init_decode_state(cfg, 2, 16, device="cpu")
    for t in (3, 5, 7):
        step(st, [t, t + 1])
    cont = M.init_decode_state(cfg, 2, 16, device="cpu")
    for t in (3, 5, 7):
        step(cont, [t, t + 1])
    M.reset_decode_slots(cfg, st, np.array([True, False]))
    assert st["pos"].tolist() == [0, 3]
    fresh = M.init_decode_state(cfg, 2, 16, device="cpu")
    for t in (2, 4):
        la, lf, lc = step(st, [t, 9]), step(fresh, [t, 0]), step(cont,
                                                                 [t, 9])
        torch.testing.assert_close(la[0], lf[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(la[1], lc[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_init_params_counts_and_layout(name):
    """init_params materializes exactly the params the config predicts,
    under the reference's names and shapes."""
    rcfg, params, cfg, _ = _pair(name, "bfloat16")
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
        else:
            assert tuple(model.get_submodule(keys[0])[keys[1]].shape) \
                == leaf.shape, keys
    assert model.layers[0]["ln1"]["scale"].dtype == torch.float32
    assert model.layers[0]["attn"]["wq"].dtype == torch.bfloat16


def test_params_from_reference_checks_names_and_shapes():
    rcfg, params, cfg, _ = _pair("llama3.2-3b", "float32")
    tree = jax.tree.map(np.asarray, params)
    bad = dict(tree, final_norm={"scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="final_norm/scale"):
        M.params_from_reference(cfg, bad, "cpu")
    bad = dict(tree, extra={})
    with pytest.raises(ValueError, match="keys"):
        M.params_from_reference(cfg, bad, "cpu")


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "zamba2-7b",
                                  "seamless-m4t-medium",
                                  "llava-next-mistral-7b"])
def test_other_families_wait_for_slice_3(arch):
    """Every family beside the dense one builds now: the hybrid family
    (zamba2-7b) came with slice 3b, MoE (mixtral-8x7b) with slice 3c, and
    enc-dec (seamless-m4t-medium) and VLM (llava-next-mistral-7b) with
    slice 3d. Each holds the parameters its config counts, and its decode
    state has the JAX package's keys."""
    cfg = reduced(get_config(arch))
    model = M.init_params(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    ref = RM.init_decode_state(ref_reduced(ref_get_config(arch)), 2, 8)
    assert set(M.init_decode_state(cfg, 2, 8, device="cpu")) == set(ref)


def test_primitives_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32) * 7
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          5e5).numpy(),
        np.asarray(ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         5e5)), atol=1e-5, rtol=1e-5)
    kv = rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        attn._repeat_kv(torch.from_numpy(kv), 6).numpy(),
        np.asarray(ref_attn._repeat_kv(jnp.asarray(kv), 6)))
    q_pos, k_pos = np.arange(3, 9), np.arange(0, 9)
    np.testing.assert_array_equal(
        attn._causal_window_mask(torch.from_numpy(q_pos),
                                 torch.from_numpy(k_pos), 4).numpy(),
        np.asarray(ref_attn._causal_window_mask(jnp.asarray(q_pos),
                                                jnp.asarray(k_pos), 4)))


def test_attention_cross_waits_for_encdec_slice():
    """Cross-attention came with the enc-dec slice: ``attention(kv_x=...)``
    with a layer of the reduced llama3.2-3b against the reference's, 8
    queries over a memory of 5, no rope and no mask (grouped K/V heads:
    ``tests/test_torch_encdec_model.py``)."""
    rcfg, params, cfg, model = _pair("llama3.2-3b", "float32")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    p_ref = jax.tree.map(lambda v: v[0], params["layers"])["attn"]
    ref = ref_attn.attention(rcfg, p_ref, jnp.asarray(x),
                             kv_x=jnp.asarray(mem), causal=False, rope=False)
    out = attn.attention(cfg, model.layers[0]["attn"], torch.from_numpy(x),
                         kv_x=torch.from_numpy(mem), causal=False,
                         rope=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_synthetic_batch_structure_matches_reference(kind):
    rcfg, cfg = _cfgs("llama3.2-3b", "bfloat16")
    shape = ShapeSpec("t", kind, 16, 2)
    ref = RM.synthetic_batch(rcfg, shape)
    out = M.synthetic_batch(cfg, shape, seed=0, device="cpu")
    assert set(out) == set(ref)
    for name, arr in ref.items():
        assert tuple(out[name].shape) == arr.shape
        assert str(out[name].dtype).removeprefix("torch.") == str(arr.dtype)
    assert int(out["tokens"].max()) < cfg.vocab_size
    assert torch.equal(out["tokens"], M.synthetic_batch(
        cfg, shape, seed=0, device="cpu")["tokens"])


def test_module_is_a_torch_module():
    _, _, cfg, model = _pair("granite-20b", "float32")
    assert isinstance(model, TransformerLM)
    assert "unembed" in model.embedding
    assert model.layers[1]["mlp"]["w_up"].shape == (cfg.d_model, cfg.d_ff)
    assert not any(p.requires_grad for p in model.parameters())
