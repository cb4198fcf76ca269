"""The port's VLM (llava-next-mistral-7b's family) against the JAX package
on the CPU.

The reference's ``init_params`` draws the weights; ``params_from_reference``
carries them into the port, so both packages run the same model. Token ids
and the stubbed patch embeddings come from numpy seeds; the patches arrive
as bf16, as ``synthetic_batch`` makes them. The VLM is the dense block
with a vision prefix: the patches, cast to the model's dtype, through
``frontend.proj`` and ``frontend.ln`` (B2 on the card), in front of the
token embeddings, so the logits cover P + S positions. Decode takes tokens
only, in both packages. On the CPU the port's RMSNorm and attention take
their kernels' plain versions (B2 and B3 on the card).

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
from repro_torch import models as M
from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.models import layers

ARCH = "llava-next-mistral-7b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SEQ = 24      # tokens
PATCHES = 8   # the reduced config's frontend_tokens
STEPS = 16


def _cfgs(dtype):
    return (dataclasses.replace(ref_reduced(ref_get_config(ARCH)),
                                dtype=dtype),
            dataclasses.replace(reduced(get_config(ARCH)), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _pair(dtype):
    """(ref cfg, ref params, port cfg, port model), same weights."""
    rcfg, cfg = _cfgs(dtype)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    model = M.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    "cpu")
    return rcfg, params, cfg, model


def _inputs(cfg, seed=0, seq=SEQ, patches=PATCHES):
    """tokens int32 (2, seq) and patches float32 (2, patches, D) rounded to
    bf16, as numpy arrays."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (2, seq), dtype=np.int32)
    pt = rng.standard_normal((2, patches, cfg.d_model)).astype(np.float32)
    return tokens, torch.from_numpy(pt).to(torch.bfloat16).float().numpy()


def _rel(port, ref):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    return float(np.max(np.abs(port.float().numpy() - ref))
                 / np.max(np.abs(ref)))


def _both(rcfg, params, cfg, model, tokens, patches=None):
    """(port logits, reference logits) of one forward."""
    rb, pb = {"tokens": jnp.asarray(tokens)}, {
        "tokens": torch.from_numpy(tokens)}
    if patches is not None:
        rb["patches"] = jnp.asarray(patches).astype(jnp.bfloat16)
        pb["patches"] = torch.from_numpy(patches).to(torch.bfloat16)
    ref, _ = jax.jit(functools.partial(RM.forward, rcfg))(params, rb)
    out, aux = M.forward(cfg, model, pb)
    assert float(aux) == 0.0
    return out, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_patches_matches_reference(dtype):
    """Logits over the P patches and the S tokens, the patches first."""
    rcfg, params, cfg, model = _pair(dtype)
    tokens, patches = _inputs(cfg)
    out, ref = _both(rcfg, params, cfg, model, tokens, patches)
    assert out.shape == (2, PATCHES + SEQ, cfg.padded_vocab()) == ref.shape
    assert out.dtype == model.embedding["embed"].dtype
    assert _rel(out, ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_without_patches_matches_reference(dtype):
    rcfg, params, cfg, model = _pair(dtype)
    tokens, _ = _inputs(cfg, seed=1)
    out, ref = _both(rcfg, params, cfg, model, tokens)
    assert out.shape == (2, SEQ, cfg.padded_vocab())
    assert _rel(out, ref) < TOL[dtype]


def test_patches_move_the_token_logits():
    """The prefix reaches the tokens: their logits with patches in front
    are not those of the tokens alone."""
    rcfg, params, cfg, model = _pair("float32")
    tokens, patches = _inputs(cfg, seed=2)
    with_p, _ = _both(rcfg, params, cfg, model, tokens, patches)
    alone, _ = _both(rcfg, params, cfg, model, tokens)
    moved = float((with_p[:, PATCHES:] - alone).abs().max()
                  / alone.abs().max())
    assert moved > 100 * TOL["float32"]


def test_patch_norm_is_one_more_rms_norm(monkeypatch):
    """The vision prefix adds one RMSNorm (``frontend.ln``, over the patch
    rows, first) to the dense block's 2n + 1."""
    _, _, cfg, model = _pair("float32")
    tokens, patches = _inputs(cfg, seed=3)
    calls = []
    norm = layers.rms_norm

    def counted(x, p, eps):
        calls.append(tuple(x.shape))
        return norm(x, p, eps)

    monkeypatch.setattr(layers, "rms_norm", counted)
    M.forward(cfg, model, {"tokens": torch.from_numpy(tokens),
                           "patches": torch.from_numpy(patches)})
    assert len(calls) == 2 * cfg.num_layers + 2
    assert calls[0] == (2, PATCHES, cfg.d_model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_logits_match_reference(dtype):
    rcfg, params, cfg, model = _pair(dtype)
    tokens, _ = _inputs(cfg, seed=4, seq=STEPS)
    step = jax.jit(functools.partial(RM.decode_step, rcfg))
    rst = RM.init_decode_state(rcfg, 2, 24)
    st = M.init_decode_state(cfg, 2, 24, device="cpu")
    assert set(st) == set(rst) == {"pos", "kv"}
    worst = 0.0
    for t in range(STEPS):
        ref, rst = step(params, rst, jnp.asarray(tokens[:, t]))
        out, st = M.decode_step(cfg, model, st,
                                torch.from_numpy(tokens[:, t]))
        worst = max(worst, _rel(out, ref))
    assert worst < TOL[dtype]
    assert st["pos"].tolist() == np.asarray(rst["pos"]).tolist()
    assert _rel(st["kv"]["k"], rst["kv"]["k"]) <= max(TOL[dtype], 2.0 ** -7)


def test_port_forward_without_patches_matches_its_own_decode():
    """The reference's own check (tests/test_arch_smoke.py) inside the port,
    on tokens only, as decode takes them."""
    _, _, cfg, model = _pair("float32")
    tokens = torch.from_numpy(_inputs(cfg, seed=5, seq=16)[0])
    full, _ = M.forward(cfg, model, {"tokens": tokens})
    st = M.init_decode_state(cfg, 2, 16, device="cpu")
    dec = torch.stack([M.decode_step(cfg, model, st, tokens[:, t])[0]
                       for t in range(16)], dim=1)
    assert float((dec - full).abs().max() / full.abs().max()) < 5e-3


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-medium"])
def test_synthetic_batch_structure_matches_reference(arch, kind):
    """The frontends' batches: patches (P = min(frontend_tokens, S/2)) and
    S - P tokens, or frames and tokens of S each; bf16 embeddings; a loss
    mask zero over the vision prefix."""
    rcfg = ref_reduced(ref_get_config(arch))
    cfg = reduced(get_config(arch))
    shape = ShapeSpec("t", kind, 32, 2)
    ref = RM.synthetic_batch(rcfg, shape)
    out = M.synthetic_batch(cfg, shape, seed=0, device="cpu")
    assert set(out) == set(ref)
    for name, arr in ref.items():
        assert tuple(out[name].shape) == arr.shape, name
        assert str(out[name].dtype).removeprefix("torch.") == str(arr.dtype)
    if "loss_mask" in out:
        np.testing.assert_array_equal(out["loss_mask"].numpy(),
                                      np.asarray(ref["loss_mask"]))


def test_init_params_counts_and_layout():
    rcfg, params, cfg, _ = _pair("bfloat16")
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert model.frontend["proj"].shape == params["frontend"]["proj"].shape
    assert model.frontend["ln"]["scale"].dtype == torch.float32
    assert not hasattr(model, "encoder")
