"""The port's hybrid LM (Mamba2 blocks with a shared attention block heading
each group, zamba2-7b's family) against the JAX package on the CPU.

The reference's ``init_params`` draws the weights; ``params_from_reference``
carries them into the port, so both packages run the same model. Token ids
come from numpy seeds. On the CPU the port's RMSNorm and attention take
their kernels' plain versions (B2 and B3 on the card).

The stock reduced zamba2 has 2 layers and ``attn_every`` 2: one group and
no tail. These tests run it at 5 layers (two groups of 2 and a tail of 1),
so the tail path runs, and one at head dim 112, zamba2-7b's, so the
attention runs at the head dim the card's B3 takes for it.

Random init leaves ``A_log`` and ``dt_bias`` at 0, so each Mamba state
decays by about exp(-softplus(0)) = 0.5 a step and forgets within a few
tokens. The "shifted" weights draw ``A_log`` near -3 (decays near 0.97),
``dt_bias``, ``D`` and the conv bias from a numpy seed, so tokens far
back matter and every term of the block is exercised.

Tolerances, as a share of the reference's max |logits|: 1e-4 in float32,
2e-2 in bfloat16.
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
from repro.models.transformer import hybrid_groups as ref_hybrid_groups
from repro_torch import models as M
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models.transformer import (
    TransformerLM, decode_state_cache_keys, hybrid_groups)

ARCH = "zamba2-7b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LAYERS = 5  # two groups of attn_every = 2 and a tail of 1
SEQ = 32
STEPS = 16


def _cfgs(dtype, **changes):
    changes = dict(dtype=dtype, num_layers=LAYERS, **changes)
    return (dataclasses.replace(ref_reduced(ref_get_config(ARCH)), **changes),
            dataclasses.replace(reduced(get_config(ARCH)), **changes))


def _shift(params):
    """A_log, dt_bias, D and conv_b of every Mamba layer from a numpy seed,
    in the groups' then the tail's stacked leaves."""
    rng = np.random.default_rng(7)
    out = dict(params)
    for key in ("groups", "tail"):
        mamba = dict(params[key]["mamba"])
        for name, draw in (("A_log", lambda sh: rng.uniform(-3.5, -2.5, sh)),
                           ("dt_bias", lambda sh: rng.uniform(-1, 1, sh)),
                           ("D", lambda sh: rng.uniform(0.5, 1.5, sh)),
                           ("conv_b", lambda sh: rng.standard_normal(sh)
                            * 0.1)):
            mamba[name] = jnp.asarray(draw(mamba[name].shape).astype(
                np.float32)).astype(mamba[name].dtype)
        out[key] = dict(params[key], mamba=mamba)
    return out


@functools.lru_cache(maxsize=None)
def _pair(dtype, shifted=False, **changes):
    """(ref cfg, ref params, port cfg, port model), same weights."""
    rcfg, cfg = _cfgs(dtype, **changes)
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


def test_reduced_configs_have_groups_and_a_tail():
    rcfg, cfg = _cfgs("float32")
    assert hybrid_groups(cfg) == ref_hybrid_groups(rcfg) == (2, 1)
    assert hybrid_groups(get_config(ARCH)) == (13, 3)  # 81 = 13 x 6 + 3
    assert hybrid_groups(reduced(get_config(ARCH))) == (1, 0)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(dtype, shifted):
    rcfg, params, cfg, model = _pair(dtype, shifted)
    tokens = _tokens(cfg)
    ref = _ref_forward(rcfg, params, tokens)
    before = flash_attention_cuda.launches
    out, aux = M.forward(cfg, model, {"tokens": torch.from_numpy(tokens)})
    assert flash_attention_cuda.launches == before  # the CPU takes plain
    assert out.shape == (2, SEQ, cfg.padded_vocab())
    assert out.dtype == model.embedding["embed"].dtype
    assert float(aux) == 0.0
    assert _rel(out, ref) < TOL[dtype]


def test_forward_at_zamba2_head_dim_matches_reference():
    """The shared attention at head dim 112, zamba2-7b's own."""
    rcfg, params, cfg, model = _pair("float32", True, head_dim=112)
    assert cfg.resolved_head_dim == 112
    tokens = _tokens(cfg, seed=4)
    ref = _ref_forward(rcfg, params, tokens)
    out, _ = M.forward(cfg, model, {"tokens": torch.from_numpy(tokens)})
    assert _rel(out, ref) < TOL["float32"]


@pytest.mark.parametrize("chunk", [4, SEQ, 12])
def test_forward_does_not_depend_on_ssm_chunk(chunk):
    """Chunks of 4 and of S, and 12, which does not divide S = 32 (one
    chunk of S then), all give the reference's logits at its chunk of 8."""
    rcfg, params, cfg8, model = _pair("float32", True)
    _, cfg = _cfgs("float32", ssm_chunk=chunk)
    tokens = _tokens(cfg, seed=3)
    ref = _ref_forward(rcfg, params, tokens)
    out, _ = M.forward(cfg, model, {"tokens": torch.from_numpy(tokens)})
    assert _rel(out, ref) < TOL["float32"]


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_logits_and_state_match_reference(dtype, shifted):
    rcfg, params, cfg, model = _pair(dtype, shifted)
    tokens = _tokens(cfg, seed=1, shape=(2, STEPS))
    step = jax.jit(functools.partial(RM.decode_step, rcfg))
    rst = RM.init_decode_state(rcfg, 2, 24)
    st = M.init_decode_state(cfg, 2, 24, device="cpu")
    leaves = {(key, name): leaf.data_ptr() for key in ("mamba", "mamba_tail",
                                                       "attn")
              for name, leaf in st[key].items()}
    worst = 0.0
    for t in range(STEPS):
        ref, rst = step(params, rst, jnp.asarray(tokens[:, t]))
        out, st = M.decode_step(cfg, model, st,
                                torch.from_numpy(tokens[:, t]))
        worst = max(worst, _rel(out, ref))
    assert worst < TOL[dtype]
    assert st["pos"].tolist() == np.asarray(rst["pos"]).tolist()
    # every leaf updated in place, in the reference's dtype after a step
    assert {(key, name): leaf.data_ptr() for key in ("mamba", "mamba_tail",
                                                     "attn")
            for name, leaf in st[key].items()} == leaves
    for key in ("mamba", "mamba_tail", "attn"):
        for name, leaf in st[key].items():
            ref_leaf = rst[key][name]
            assert str(leaf.dtype).removeprefix("torch.") == str(
                ref_leaf.dtype), (key, name)
            assert tuple(leaf.shape) == ref_leaf.shape
            # bf16 leaves round values that differ by f32 noise: one bf16
            # ulp, up to 2^-7 of the largest
            tol = TOL[dtype] if leaf.dtype == torch.float32 else max(
                TOL[dtype], 2.0 ** -7)
            assert _rel(leaf, ref_leaf) <= tol, (key, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_state_dtype_after_one_step(dtype):
    """The reference starts its conv state in bf16 and carries it in the
    model's dtype from its first step on; the port holds that dtype from
    the start, so in float32 no f32 value is rounded into a bf16 buffer."""
    rcfg, params, cfg, model = _pair(dtype)
    rst = RM.init_decode_state(rcfg, 2, 8)
    assert rst["mamba"]["conv"].dtype == jnp.bfloat16
    _, rst = RM.decode_step(rcfg, params, rst, jnp.asarray([1, 2]))
    st = M.init_decode_state(cfg, 2, 8, device="cpu")
    M.decode_step(cfg, model, st, torch.tensor([1, 2], dtype=torch.int32))
    for key in ("mamba", "mamba_tail"):
        assert str(rst[key]["conv"].dtype) == dtype
        assert st[key]["conv"].dtype == getattr(torch, dtype)


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


@pytest.mark.parametrize("key,leaf", [("mamba", "ssm"), ("mamba", "conv"),
                                      ("mamba_tail", "ssm"),
                                      ("attn", "v")])
def test_decode_that_drops_a_carried_leaf_is_far_off(key, leaf):
    """The forward-vs-decode check catches a state not carried: with one
    leaf zeroed before every step the gap is more than twice the 5e-3 that
    ``test_port_forward_matches_its_own_decode`` allows (the tail's one
    layer of five moves the logits least)."""
    _, _, cfg, model = _pair("float32", True)
    tokens = torch.from_numpy(_tokens(cfg, seed=2, shape=(2, 16)))
    full, _ = M.forward(cfg, model, {"tokens": tokens})
    st = M.init_decode_state(cfg, 2, 16, device="cpu")
    steps = []
    for t in range(16):
        st[key][leaf].zero_()
        steps.append(M.decode_step(cfg, model, st, tokens[:, t])[0])
    rel = float((torch.stack(steps, dim=1) - full).abs().max()
                / full.abs().max())
    assert rel > 1e-2


def test_reset_decode_slots_isolates_streams():
    """Resetting one slot zeroes its Mamba leaves (groups and tail) and
    restarts its stream exactly (logits match a fresh state), leaves the KV
    caches alone, and leaves its neighbour's stream untouched."""
    _, _, cfg, model = _pair("float32", True)

    def step(state, toks):
        return M.decode_step(cfg, model, state,
                             torch.tensor(toks, dtype=torch.int32))[0]

    st = M.init_decode_state(cfg, 2, 16, device="cpu")
    cont = M.init_decode_state(cfg, 2, 16, device="cpu")
    for t in (3, 5, 7):
        step(st, [t, t + 1])
        step(cont, [t, t + 1])
    kv = {name: leaf.clone() for name, leaf in st["attn"].items()}
    M.reset_decode_slots(cfg, st, np.array([True, False]))
    assert st["pos"].tolist() == [0, 3]
    for key in ("mamba", "mamba_tail"):
        for leaf in st[key].values():
            assert not leaf[:, 0].any() and leaf[:, 1].any()
    for name, leaf in st["attn"].items():
        assert torch.equal(leaf, kv[name])
    fresh = M.init_decode_state(cfg, 2, 16, device="cpu")
    for t in (2, 4):
        la, lf, lc = step(st, [t, 9]), step(fresh, [t, 0]), step(cont,
                                                                 [t, 9])
        torch.testing.assert_close(la[0], lf[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(la[1], lc[1], rtol=1e-5, atol=1e-5)


def test_init_params_counts_and_layout():
    """init_params materializes exactly the params the config predicts,
    under the reference's names, shapes and dtypes; params_from_reference
    splits the groups and tail stacks per layer and keeps one shared_attn."""
    rcfg, params, cfg, ported = _pair("bfloat16")
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert len(model.groups) == 2 and len(model.tail) == 1
    assert all(len(g) == cfg.attn_every for g in model.groups)
    assert set(model.shared_attn) == {"ln", "attn"}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [k.key for k in path]
        arr = np.asarray(leaf.astype(jnp.float32))
        if keys[0] == "groups":
            for g in range(2):
                for i in range(cfg.attn_every):
                    got = ported.groups[g][i][keys[1]][keys[2]]
                    assert tuple(got.shape) == leaf.shape[2:], keys
                    np.testing.assert_array_equal(got.float().numpy(),
                                                  arr[g, i])
        elif keys[0] == "tail":
            got = ported.tail[0][keys[1]][keys[2]]
            np.testing.assert_array_equal(got.float().numpy(), arr[0])
        else:
            got = ported.get_submodule(".".join(keys[:-1]))[keys[-1]]
            assert tuple(got.shape) == leaf.shape, keys
            np.testing.assert_array_equal(got.float().numpy(), arr)
        assert str(got.dtype).removeprefix("torch.") == str(leaf.dtype)
    mamba = model.groups[0][0]["mamba"]
    assert mamba["norm_scale"].dtype == torch.float32
    assert mamba["in_proj"].dtype == torch.bfloat16


def test_model_refuses_a_wrong_group_structure():
    _, _, cfg, model = _pair("float32")
    tree = {"embedding": dict(model.embedding),
            "final_norm": dict(model.final_norm)}
    groups = [[dict(p) for p in g] for g in model.groups]
    tail = [dict(p) for p in model.tail]
    shared = {k: dict(v) for k, v in model.shared_attn.items()}
    with pytest.raises(ValueError, match="groups"):
        TransformerLM(cfg, tree["embedding"], tree["final_norm"],
                      groups=groups[:1], tail=tail, shared_attn=shared)
    with pytest.raises(ValueError, match="tail"):
        TransformerLM(cfg, tree["embedding"], tree["final_norm"],
                      groups=groups, tail=[], shared_attn=shared)
    with pytest.raises(ValueError):
        TransformerLM(cfg, tree["embedding"], tree["final_norm"],
                      groups=groups, tail=tail)


def test_decode_state_layout():
    rcfg, _, cfg, _ = _pair("float32")
    st = M.init_decode_state(cfg, 3, 8, device="cpu")
    rst = RM.init_decode_state(rcfg, 3, 8)
    assert list(st) == list(rst) == ["pos", "mamba", "mamba_tail", "attn"]
    for key in ("mamba", "mamba_tail", "attn"):
        assert set(st[key]) == set(rst[key])
        for name, leaf in st[key].items():
            assert tuple(leaf.shape) == rst[key][name].shape
    assert tuple(st["attn"]["k"].shape) == (2, 3, 8, cfg.num_kv_heads,
                                            cfg.resolved_head_dim)
    assert decode_state_cache_keys(cfg) == ("attn",)
