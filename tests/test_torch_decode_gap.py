"""Forward against teacher-forced decode, in both packages on the same weights.

The reference's own check (``tests/test_arch_smoke.py``) holds the logits of
teacher-forced ``decode_step`` to those of the full-sequence ``forward``:
max|decode - forward| / max|forward|. Decode reads K and V back from a bf16
cache where forward keeps them in the config's dtype, so the gap is the
model's own numerics, not a fault. This file measures the gap in the JAX
package and in the port on the same weights (``params_from_reference``) and
the same numpy-seeded tokens; the two must agree, since both round the same
values into the cache.

The tier-1 test runs a reduced config. Run as a script, the file measures
the gap at ``chip_smoke.py``'s model check (llama3.2-3b at full width,
float32, 4 layers, 2 x 512 tokens) on the CPU and prints one JSON line:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_decode_gap.py

That needs about 6 GiB of host memory and about 5 minutes.
"""
import dataclasses
import functools
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as RM
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro_torch import models as M
from repro_torch.configs import get_config, reduced


def _cfgs(arch, layers, small):
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    if small:
        rcfg, cfg = ref_reduced(rcfg), reduced(cfg)
    changes = dict(dtype="float32", num_layers=layers)
    return (dataclasses.replace(rcfg, **changes),
            dataclasses.replace(cfg, **changes))


def _rel(out, ref):
    return float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))


def reference_gap(rcfg, params, tokens):
    """The JAX package's gap, and its forward logits."""
    full, _ = jax.jit(functools.partial(RM.forward, rcfg))(
        params, {"tokens": jnp.asarray(tokens)})
    full = np.asarray(full)
    step = jax.jit(functools.partial(RM.decode_step, rcfg))
    st = RM.init_decode_state(rcfg, tokens.shape[0], tokens.shape[1])
    worst = 0.0
    for t in range(tokens.shape[1]):
        logits, st = step(params, st, jnp.asarray(tokens[:, t]))
        worst = max(worst, float(jnp.max(jnp.abs(logits - full[:, t]))))
    return worst / float(np.max(np.abs(full))), full


def port_gap(cfg, model, tokens):
    """The port's gap, and its forward logits."""
    tok = torch.from_numpy(tokens)
    with torch.inference_mode():
        full, _ = M.forward(cfg, model, {"tokens": tok})
        st = M.init_decode_state(cfg, tokens.shape[0], tokens.shape[1],
                                 device="cpu")
        worst = 0.0
        for t in range(tokens.shape[1]):
            logits, st = M.decode_step(cfg, model, st, tok[:, t])
            worst = max(worst, float((logits - full[:, t]).abs().max()))
    return worst / float(full.abs().max()), full.numpy()


def measure(arch, layers, seq, small):
    rcfg, cfg = _cfgs(arch, layers, small)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, seq),
                                               dtype=np.int32)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    ref, ref_full = reference_gap(rcfg, params, tokens)
    model = M.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    "cpu")
    del params
    port, port_full = port_gap(cfg, model, tokens)
    return {"arch": arch, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "layers": layers, "batch": 2, "tokens": seq, "dtype": "float32",
            "reference_gap": ref, "port_gap": port,
            "port_vs_reference_forward": _rel(port_full, ref_full)}


@pytest.mark.parametrize("arch", ["llama3.2-3b", "stablelm-1.6b"])
def test_port_gap_equals_reference_gap(arch):
    out = measure(arch, 2, 32, small=True)
    assert out["port_vs_reference_forward"] < 1e-4
    assert abs(out["port_gap"] - out["reference_gap"]) \
        <= 0.05 * out["reference_gap"] + 1e-6
    assert out["reference_gap"] < 5e-3


if __name__ == "__main__":
    t0 = time.perf_counter()
    out = measure("llama3.2-3b", 4, 512, small=False)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
