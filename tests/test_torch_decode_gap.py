"""Forward against teacher-forced decode, in both packages on the same weights.

The reference's own check (``tests/test_arch_smoke.py``) holds the logits of
teacher-forced ``decode_step`` to those of the full-sequence ``forward``:
max|decode - forward| / max|forward|. Decode reads K and V back from a bf16
cache where forward keeps them in the config's dtype, so the gap is the
model's own numerics, not a fault. This file measures the gap in the JAX
package and in the port on the same weights (``params_from_reference``) and
the same numpy-seeded tokens; the two must agree, since both round the same
values into the cache.

The tier-1 test runs reduced configs. Run as a script, the file measures
the gap at one of ``chip_smoke.py``'s model checks (full width, float32,
4 layers, or 7 for zamba2-7b: one group of 6 and a tail of 1, or 2 for
mixtral-8x7b, or 4 encoder and 4 decoder layers for seamless-m4t-medium;
2 x 512 tokens) on the CPU and prints one JSON line:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_decode_gap.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_decode_gap.py \
        rwkv6-1.6b
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_decode_gap.py \
        zamba2-7b
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_decode_gap.py \
        mixtral-8x7b
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_decode_gap.py \
        seamless-m4t-medium

llama3.2-3b (the default) needs about 6 GiB of host memory and about 5
minutes. The hybrid's decode reads its shared attention's K and V from the
bf16 cache, as the dense family's does; its Mamba conv state is held in
the config's dtype by both packages after their first step. RWKV's decode
keeps ``tm_x`` and ``cm_x`` in bf16 where forward keeps the token shift in
the config's dtype; the reference runs its chunked WKV at ``ssm_chunk`` 16
there (8 in the reduced config), where it is finite. Random init leaves
RWKV's token-shift mixes and bonus at 0, so those bf16 leaves would not
reach the logits: the script, as the smoke, runs RWKV on ``shift_rwkv``'s
weights.

The enc-dec family's forward runs on zero frames. Its encoder's memory is
then exactly 0, as the memory decode attends to is: the state's
``cross_k``/``cross_v``, which neither package ever fills (zeros). So the
cross-attention adds exactly 0 in both, and the gap is that of the
decoder's self-attention reading its bf16 cache, as the dense family's.

MoE runs at capacity factor E/k, where the forward drops no choice (a
decode step never drops one): at the config's 1.25 the forward drops
choices that decode keeps, which is why the reference leaves mixtral out
of its own check. And it runs with its routing held (``HeldRouting``, as
the smoke holds it): each decode step routes its token to the experts the
forward chose for it. A random-init mixtral at full width sends a token to
another expert wherever its router sits at a near-tie that the bf16
cache's rounding crosses, and that token's logits then move by up to their
whole size; the script counts those tokens in each package. The reference
runs eagerly there (``jax.disable_jit``), so that its ``route`` is called
layer by layer in Python. mixtral-8x7b at 2 layers needs about 26 GiB of
host memory (both packages' f32 copies, 12.7 GB each) and about an hour.
"""
import contextlib
import dataclasses
import functools
import json
import sys
import time

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
from repro_torch.models import moe as port_moe


def _cfgs(arch, layers, small):
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    if small:
        rcfg, cfg = ref_reduced(rcfg), reduced(cfg)
    changes = dict(dtype="float32", num_layers=layers)
    if cfg.is_encdec:  # as many encoder layers as decoder layers
        changes["encoder_layers"] = layers
    if cfg.family == "ssm":  # where the reference's chunked WKV is finite
        changes["ssm_chunk"] = min(cfg.ssm_chunk, 16)
    if cfg.num_experts:  # every expert can take a whole row: no drops
        changes["capacity_factor"] = cfg.num_experts / cfg.experts_per_token
    return (dataclasses.replace(rcfg, **changes),
            dataclasses.replace(cfg, **changes))


def _rel(out, ref):
    return float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))


def shift_rwkv(params, seed=7):
    """mu, mu_c, bonus_u and ln_wkv from a numpy seed, decay_base near -4
    (``chip_smoke.py`` ``shift_rwkv``: the same draws in the same order)."""
    rng = np.random.default_rng(seed)
    tm = dict(params["layers"]["tm"])
    for name, draw in (("mu", lambda sh: rng.uniform(0, 1, sh)),
                       ("mu_c", lambda sh: rng.uniform(0, 1, sh)),
                       ("bonus_u", lambda sh: rng.standard_normal(sh) * 0.5),
                       ("ln_wkv", lambda sh: rng.uniform(0.5, 1.5, sh)),
                       ("decay_base", lambda sh: rng.uniform(-4.5, -3.5, sh))):
        tm[name] = jnp.asarray(draw(tm[name].shape).astype(
            np.float32)).astype(tm[name].dtype)
    return dict(params, layers=dict(params["layers"], tm=tm))


class HeldRouting:
    """An MoE's routing held between forward and decode, as
    ``chip_smoke.py``'s ``HeldRouting`` holds it on the card: inside
    ``with``, the package's ``models.moe.route`` is patched; the forward's
    calls record their expert ids (one call a layer), and after ``hold()``
    decode step t's call at layer l routes token t to the experts the
    forward chose for it, with weights from its own router probabilities
    of those experts. ``flipped`` counts the decode tokens whose own choice
    differed. Nothing is patched for the other families."""

    def __init__(self, module, cfg, torch_side):
        self.module, self.route = module, module.route
        self.layers = cfg.num_layers if cfg.num_experts else 0
        self.torch_side = torch_side
        self.recorded, self.calls, self.flipped = [], None, 0

    def __enter__(self):
        if self.layers:
            self.module.route = self._route
        return self

    def __exit__(self, *exc):
        self.module.route = self.route

    def hold(self):
        self.calls = 0

    def _route(self, cfg, p, x):
        w, ids, aux = self.route(cfg, p, x)
        if self.calls is None:
            self.recorded.append(np.asarray(ids))
            return w, ids, aux
        layer, t = self.calls % self.layers, self.calls // self.layers
        held = self.recorded[layer][:, t:t + 1]
        self.calls += 1
        self.flipped += int((np.sort(np.asarray(ids), -1)
                             != np.sort(held, -1)).any(-1).sum())
        if self.torch_side:
            probs = torch.softmax(x.float() @ p["router"], -1)
            w = probs.gather(-1, torch.from_numpy(held).long())
            w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
            return w.to(x.dtype), torch.from_numpy(held).long(), aux
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], -1)
        w = jnp.take_along_axis(probs, jnp.asarray(held), -1)
        w = w / jnp.maximum(w.sum(-1, keepdims=True), 1e-9)
        return w.astype(x.dtype), jnp.asarray(held), aux


def zero_frames(cfg, tokens):
    """The enc-dec family's frames, (B, S, D) zeros (float32; both forwards
    cast them to the model's dtype); None for the other families."""
    if not cfg.is_encdec:
        return None
    return np.zeros(tokens.shape + (cfg.d_model,), np.float32)


def reference_gap(rcfg, params, tokens):
    """The JAX package's gap, its forward logits, and the decode tokens
    whose own routing differed from the forward's. An MoE runs without
    ``jit`` (``lax.scan`` then calls ``route`` layer by layer in Python,
    where ``HeldRouting`` holds it)."""
    moe = bool(rcfg.num_experts)
    with (jax.disable_jit() if moe else contextlib.nullcontext()), \
            HeldRouting(ref_moe, rcfg, False) as routing:
        # remat traces its function even without jit; it changes no value
        batch = {"tokens": jnp.asarray(tokens)}
        if rcfg.is_encdec:
            batch["frames"] = jnp.asarray(zero_frames(rcfg, tokens))
        full, _ = jax.jit(functools.partial(
            RM.forward, rcfg, remat="none" if moe else None))(params, batch)
        full = np.asarray(full)
        routing.hold()
        step = jax.jit(functools.partial(RM.decode_step, rcfg))
        st = RM.init_decode_state(rcfg, tokens.shape[0], tokens.shape[1])
        worst = 0.0
        for t in range(tokens.shape[1]):
            logits, st = step(params, st, jnp.asarray(tokens[:, t]))
            worst = max(worst, float(jnp.max(jnp.abs(logits - full[:, t]))))
    return worst / float(np.max(np.abs(full))), full, routing.flipped


def port_gap(cfg, model, tokens):
    """The port's gap, its forward logits, and the decode tokens whose own
    routing differed from the forward's."""
    tok = torch.from_numpy(tokens)
    with torch.inference_mode(), HeldRouting(port_moe, cfg,
                                             True) as routing:
        batch = {"tokens": tok}
        if cfg.is_encdec:
            batch["frames"] = torch.from_numpy(zero_frames(cfg, tokens))
        full, _ = M.forward(cfg, model, batch)
        routing.hold()
        st = M.init_decode_state(cfg, tokens.shape[0], tokens.shape[1],
                                 device="cpu")
        worst = 0.0
        for t in range(tokens.shape[1]):
            logits, st = M.decode_step(cfg, model, st, tok[:, t])
            worst = max(worst, float((logits - full[:, t]).abs().max()))
    return worst / float(full.abs().max()), full.numpy(), routing.flipped


def measure(arch, layers, seq, small, shifted=False):
    rcfg, cfg = _cfgs(arch, layers, small)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, seq),
                                               dtype=np.int32)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    if shifted:
        params = shift_rwkv(params)
    ref, ref_full, ref_flipped = reference_gap(rcfg, params, tokens)
    model = M.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    "cpu")
    del params
    port, port_full, port_flipped = port_gap(cfg, model, tokens)
    return {"arch": arch, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "layers": layers, "batch": 2, "tokens": seq, "dtype": "float32",
            "shifted": shifted,
            "reference_gap": ref, "port_gap": port,
            "held_routing": bool(cfg.num_experts),
            "reference_tokens_routed_otherwise": ref_flipped,
            "port_tokens_routed_otherwise": port_flipped,
            "port_vs_reference_forward": _rel(port_full, ref_full)}


@pytest.mark.parametrize("arch,shifted,layers", [
    *(pytest.param(a, False, 2, id=a)
      for a in ("llama3.2-3b", "stablelm-1.6b", "rwkv6-1.6b")),
    # where decode's bf16 tm_x/cm_x and the bonus reach the logits
    pytest.param("rwkv6-1.6b", True, 2, id="rwkv6-1.6b-shifted"),
    # two groups of attn_every = 2 and a tail of 1
    pytest.param("zamba2-7b", False, 5, id="zamba2-7b"),
    pytest.param("mixtral-8x7b", False, 2, id="mixtral-8x7b"),
    # zero frames: two encoder and two decoder layers
    pytest.param("seamless-m4t-medium", False, 2, id="seamless-m4t-medium")])
def test_port_gap_equals_reference_gap(arch, shifted, layers):
    out = measure(arch, layers, 32, small=True, shifted=shifted)
    assert out["port_vs_reference_forward"] < 1e-4
    assert abs(out["port_gap"] - out["reference_gap"]) \
        <= 0.05 * out["reference_gap"] + 1e-6
    assert out["reference_gap"] < 5e-3


if __name__ == "__main__":
    t0 = time.perf_counter()
    arch = sys.argv[1] if len(sys.argv) > 1 else "llama3.2-3b"
    family = get_config(arch).family
    layers = {"hybrid": 7, "moe": 2}.get(family, 4)
    out = measure(arch, layers, 512, small=False, shifted=family == "ssm")
    out["encoder_layers"] = layers if get_config(arch).is_encdec else 0
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
