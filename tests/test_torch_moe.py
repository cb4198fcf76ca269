"""The port's MoE (router, capacity-based dispatch, expert FFNs, and the LM
built on them, mixtral-8x7b's and grok-1-314b's family) against the JAX
package on the CPU.

The reference's ``init_params`` draws the weights; the tests carry them
across (``params_from_reference``, or layer 0's ``moe`` leaves as numpy
arrays), so both packages run the same model. Inputs and token ids come
from numpy seeds. The reduced configs (``reduced``) have 4 experts, top-2,
capacity factor 1.25, as the reference's own capacity test
(``tests/test_arch_smoke.py``) runs them.

Three parity hazards each have a test: top-k ties (``jax.lax.top_k`` keeps
the lower expert first), capacity drops (the same (row, token, choice)
pairs dropped) and the trash slot (dropped pairs contribute nothing).

Tolerances: ``moe_apply`` and the logits as a share of the reference's max
|out|, 1e-5 (MoE alone) or 1e-4 (the model) in float32 and 2e-2 in
bfloat16; the aux loss to 1e-6 relative, and the model's sum of the
layers' aux losses to 1e-6 in float32 and 1e-4 in bfloat16, where the two
packages' router inputs already differ by bf16 rounding.
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
from repro.models import moe as ref_moe
from repro_torch import models as M
from repro_torch.configs import get_config, reduced
from repro_torch.models import moe
from repro_torch.models.transformer import decode_state_cache_keys

ARCHS = ("mixtral-8x7b", "grok-1-314b")
MOE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
AUX_RTOL = 1e-6
MODEL_AUX_RTOL = {"float32": 1e-6, "bfloat16": 1e-4}
SEQ = 32
STEPS = 16


def _cfgs(arch, dtype, **changes):
    changes = dict(dtype=dtype, **changes)
    return (dataclasses.replace(ref_reduced(ref_get_config(arch)), **changes),
            dataclasses.replace(reduced(get_config(arch)), **changes))


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype, **changes):
    """(ref cfg, ref params, port cfg, port model), same weights."""
    rcfg, cfg = _cfgs(arch, dtype, **changes)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    model = M.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    "cpu")
    return rcfg, params, cfg, model


def _layer0(arch, dtype):
    """Layer 0's ``moe`` leaves: (ref cfg, ref leaves, port cfg, port
    leaves)."""
    rcfg, params, cfg, model = _pair(arch, dtype)
    ref = jax.tree.map(lambda v: v[0], params["layers"]["moe"])
    return rcfg, ref, cfg, model.layers[0]["moe"]


def _x(cfg, seed=0, shape=(2, SEQ), shared=False):
    """An input from a numpy seed, in both packages, in cfg's dtype;
    ``shared`` adds one direction to all tokens of a row, so that they
    prefer the same experts."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (cfg.d_model,))
    if shared:
        x = x + rng.standard_normal((shape[0], 1, cfg.d_model))
    x = x.astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, cfg.dtype))
    return jnp.asarray(x).astype(cfg.dtype), t


def _tokens(cfg, seed=0, shape=(2, SEQ)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(port, ref):
    ref = _np(ref)
    return float(np.max(np.abs(_np(port) - ref)) / np.max(np.abs(ref)))


def _dropped(ids, num_experts, cap):
    """The (row, token, choice) pairs past their expert's capacity, by an
    independent count: each row's pairs in (token, choice) order, each
    taking the next slot of its expert."""
    ids = np.asarray(ids)
    out = set()
    for b in range(ids.shape[0]):
        taken = [0] * num_experts
        for s in range(ids.shape[1]):
            for c in range(ids.shape[2]):
                e = int(ids[b, s, c])
                taken[e] += 1
                if taken[e] > cap:
                    out.add((b, s, c))
    return out


@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0, 4.0])
@pytest.mark.parametrize("arch", [*ARCHS, "mixtral-8x7b-full"])
def test_capacity_matches_reference(arch, cf):
    name = arch.removesuffix("-full")
    rcfg, cfg = ref_get_config(name), get_config(name)
    if arch == name:
        rcfg, cfg = ref_reduced(rcfg), reduced(cfg)
    rcfg, cfg = (dataclasses.replace(c, capacity_factor=cf)
                 for c in (rcfg, cfg))
    for s in (1, 3, SEQ, 512, 2048):
        assert moe.capacity(cfg, s) == ref_moe.capacity(rcfg, s), s


def test_capacity_of_mixtral_at_its_smoke_shapes():
    """Decode (S = 1) gets k slots an expert; a 2 x 2048 forward 640 a
    row; at capacity factor E/k every expert can take a whole row."""
    cfg = get_config("mixtral-8x7b")
    assert moe.capacity(cfg, 1) == 2
    assert moe.capacity(cfg, 2048) == 640
    no_drops = dataclasses.replace(cfg, capacity_factor=4.0)
    assert moe.capacity(no_drops, 512) == 512


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch, dtype):
    rcfg, rp, cfg, p = _layer0(arch, dtype)
    rx, x = _x(cfg)
    rw, rids, raux = ref_moe.route(rcfg, rp, rx)
    w, ids, aux = moe.route(cfg, p, x)
    assert w.dtype == x.dtype and aux.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    assert _rel(w, rw) < MOE_TOL[dtype]
    assert abs(float(aux) - float(raux)) <= AUX_RTOL * abs(float(raux))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, dtype):
    rcfg, rp, cfg, p = _layer0(arch, dtype)
    rx, x = _x(cfg, seed=1)
    ref, raux = ref_moe.moe_apply(rcfg, rp, rx)
    out, aux = moe.moe_apply(cfg, p, x)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert _rel(out, ref) < MOE_TOL[dtype]
    assert abs(float(aux) - float(raux)) <= AUX_RTOL * abs(float(raux))


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_pick_the_lower_experts(arch):
    """With the router at zero every probability is 1/E: both packages
    route every token to experts (0, 1), weights 1/2 each."""
    rcfg, rp, cfg, p = _layer0(arch, "float32")
    rp = dict(rp, router=jnp.zeros_like(rp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    rx, x = _x(cfg, seed=2)
    _, rids, _ = ref_moe.route(rcfg, rp, rx)
    w, ids, _ = moe.route(cfg, p, x)
    want = np.broadcast_to([0, 1], (2, SEQ, 2))
    np.testing.assert_array_equal(np.asarray(rids), want)
    np.testing.assert_array_equal(ids.numpy(), want)
    assert torch.equal(w, torch.full_like(w, 0.5))
    # and the outputs agree: experts 0 and 1 take all choices, so with
    # capacity 20 of 32 tokens the last 12 of each row drop both
    ref, _ = ref_moe.moe_apply(rcfg, rp, rx)
    out, _ = moe.moe_apply(cfg, p, x)
    assert _rel(out, ref) < MOE_TOL["float32"]
    assert not out[:, moe.capacity(cfg, SEQ):].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_match_reference(arch, dtype):
    """At capacity factor 1.25 and S = 32 the input drops choices; the
    port's dispatch drops exactly the pairs an independent count of the
    reference's expert ids drops, and the outputs agree, so the reference
    dropped them too."""
    rcfg, rp, cfg, p = _layer0(arch, dtype)
    rx, x = _x(cfg, seed=0, shared=True)
    cap = moe.capacity(cfg, SEQ)
    _, rids, _ = ref_moe.route(rcfg, rp, rx)
    _, ids, _ = moe.route(cfg, p, x)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    want = _dropped(rids, cfg.num_experts, cap)
    assert want, "the input drops no choice"
    dest, keep = moe.dispatch_slots(ids, cfg.num_experts, cap)
    got = {(b, n // 2, n % 2) for b, n in zip(*np.nonzero(~keep.numpy()))}
    assert got == want
    # dropped pairs go to the trash slot, kept ones to distinct slots
    trash = cfg.num_experts * cap
    assert bool((dest[~keep] == trash).all())
    for row in range(dest.shape[0]):
        kept = dest[row][keep[row]]
        assert len(set(kept.tolist())) == len(kept) and kept.max() < trash
    ref, _ = ref_moe.moe_apply(rcfg, rp, rx)
    out, _ = moe.moe_apply(cfg, p, x)
    assert _rel(out, ref) < MOE_TOL[dtype]


def test_dropped_choices_contribute_nothing():
    """A token whose choices all drop gets a zero output (the trash slot
    and the pad row are thrown away): at capacity k, every token after the
    first few of a row loses both choices."""
    _, _, cfg, p = _layer0("mixtral-8x7b", "float32")
    cfg = dataclasses.replace(cfg, capacity_factor=0.0)
    _, x = _x(cfg, seed=4)
    out, _ = moe.moe_apply(cfg, p, x)
    _, ids, _ = moe.route(cfg, p, x)
    _, keep = moe.dispatch_slots(ids, cfg.num_experts, moe.capacity(cfg,
                                                                    SEQ))
    none_kept = ~keep.reshape(2, SEQ, 2).any(-1)
    assert none_kept.sum() >= SEQ  # most tokens lose both choices
    assert not out[none_kept].any()
    assert out[~none_kept].abs().amax(-1).min() > 0


# ---------------------------------------------------------------------------
# The MoE LM: forward, aux, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_reference(arch, dtype):
    rcfg, params, cfg, model = _pair(arch, dtype)
    tokens = _tokens(cfg)
    ref, raux = jax.jit(functools.partial(RM.forward, rcfg))(
        params, {"tokens": jnp.asarray(tokens)})
    out, aux = M.forward(cfg, model, {"tokens": torch.from_numpy(tokens)})
    assert out.shape == (2, SEQ, cfg.padded_vocab())
    assert out.dtype == model.embedding["embed"].dtype
    assert _rel(out, ref) < TOL[dtype]
    # the sum of the layers' losses, each near 1 (balanced routing)
    assert aux.dtype == torch.float32 and float(aux) > cfg.num_layers * 0.5
    assert abs(float(aux) - float(raux)) <= MODEL_AUX_RTOL[dtype] * abs(
        float(raux))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_match_reference(arch, dtype):
    """Teacher-forced decode in both packages; mixtral's window of 8 (the
    reduced 32, cut) wraps its ring-buffer cache twice in 16 steps."""
    changes = {"sliding_window": 8} if arch == "mixtral-8x7b" else {}
    rcfg, params, cfg, model = _pair(arch, dtype, **changes)
    tokens = _tokens(cfg, seed=1, shape=(2, STEPS))
    step = jax.jit(functools.partial(RM.decode_step, rcfg))
    rst = RM.init_decode_state(rcfg, 2, 24)
    st = M.init_decode_state(cfg, 2, 24, device="cpu")
    assert tuple(st["kv"]["k"].shape) == rst["kv"]["k"].shape
    worst = 0.0
    for t in range(STEPS):
        ref, rst = step(params, rst, jnp.asarray(tokens[:, t]))
        out, st = M.decode_step(cfg, model, st,
                                torch.from_numpy(tokens[:, t]))
        worst = max(worst, _rel(out, ref))
    assert worst < TOL[dtype]
    assert st["pos"].tolist() == np.asarray(rst["pos"]).tolist()
    np.testing.assert_allclose(
        st["kv"]["k"].float().numpy(),
        np.asarray(rst["kv"]["k"].astype(jnp.float32)),
        atol=TOL[dtype] * 10, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_forward_matches_its_own_decode(arch):
    """The reference's own check (tests/test_arch_smoke.py), inside the
    port, at capacity factor E/k, where the forward drops no choice: a
    decode step (S = 1, capacity k) never drops one."""
    rcfg, cfg = _cfgs(arch, "float32")
    no_drops = cfg.num_experts / cfg.experts_per_token
    _, _, cfg, model = _pair(arch, "float32", capacity_factor=no_drops)
    tokens = torch.from_numpy(_tokens(cfg, seed=2, shape=(2, 16)))
    full, _ = M.forward(cfg, model, {"tokens": tokens})
    st = M.init_decode_state(cfg, 2, 16, device="cpu")
    dec = torch.stack([M.decode_step(cfg, model, st, tokens[:, t])[0]
                       for t in range(16)], dim=1)
    rel = float((dec - full).abs().max() / full.abs().max())
    assert rel < 5e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_counts_and_layout(arch):
    """init_params materializes exactly the params the config predicts,
    under the reference's names, shapes and dtypes (the router in f32);
    params_from_reference carries the ``moe`` leaves across as they are."""
    rcfg, params, cfg, ported = _pair(arch, "bfloat16")
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in model.parameters()) == cfg.param_count()
    assert "mlp" not in model.layers[0]
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [k.key for k in path]
        arr = np.asarray(leaf.astype(jnp.float32))
        if keys[0] == "layers":
            for i in range(cfg.num_layers):
                got = ported.layers[i]
                for k in keys[1:]:
                    got = got[k]
                assert tuple(got.shape) == leaf.shape[1:], keys
                np.testing.assert_array_equal(got.float().numpy(), arr[i])
        else:
            got = ported.get_submodule(keys[0])[keys[1]]
            np.testing.assert_array_equal(got.float().numpy(), arr)
        assert str(got.dtype).removeprefix("torch.") == str(leaf.dtype)
    p = model.layers[0]["moe"]
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert p["router"].shape == (d, e) and p["router"].dtype == torch.float32
    assert p["w_gate"].shape == p["w_up"].shape == (e, d, f)
    assert p["w_down"].shape == (e, f, d)
    assert p["w_gate"].dtype == torch.bfloat16


def test_decode_state_layout():
    rcfg, _, cfg, _ = _pair("mixtral-8x7b", "float32")
    st = M.init_decode_state(cfg, 3, 64, device="cpu")
    rst = RM.init_decode_state(rcfg, 3, 64)
    assert list(st) == list(rst) == ["pos", "kv"]
    # the reduced window of 32 bounds the cache
    assert tuple(st["kv"]["k"].shape) == rst["kv"]["k"].shape == (
        cfg.num_layers, 3, 32, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert decode_state_cache_keys(cfg) == ("kv",)
