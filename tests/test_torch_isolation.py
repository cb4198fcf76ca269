"""The port stands alone: no module of ``repro_torch`` imports JAX or the
JAX package (``models/ssm.py``, ``models/moe.py``, the hybrid, MoE, enc-dec
and VLM entry points, migration, placement and the fleet included), and its
entry points raise without CUDA instead of falling back to the CPU. The
training path (``optim/``, ``data/``, the ``Checkpointer``,
``launch/train.py``) and the race lint are covered too: ``train()``
raises without CUDA and trains on ``device="cpu"``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(PKG.parent).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PKG.rglob("*.py"))

_SCRIPT = r"""
import importlib, sys
mods = sys.argv[1:]
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad

import numpy as np
import torch
assert not torch.cuda.is_available()
from repro_torch.apps.himeno_app import HimenoApp
from repro_torch.core.verifier import HimenoMeasuredBackend
from repro_torch.kernels.himeno import (
    himeno_init, himeno_stencil, himeno_sweep, state_from_reference)
from repro_torch.kernels.himeno.kernel import load_library

def raises(fn, exc):
    try:
        fn()
    except exc:
        return
    raise AssertionError(f"{fn} did not raise {exc.__name__}")

raises(HimenoApp, RuntimeError)
raises(HimenoMeasuredBackend, RuntimeError)
raises(load_library, RuntimeError)
raises(lambda: himeno_init((5, 5, 5)), RuntimeError)
st = himeno_init((5, 5, 5), device="cpu")
raises(lambda: state_from_reference({k: v.numpy() for k, v in st.items()},
                                    None), RuntimeError)
meta = {k: v.to("meta") for k, v in st.items()}
args = [meta[k] for k in ("p", "a", "b", "c", "bnd", "wrk1")]
raises(lambda: himeno_sweep(*args), ValueError)
raises(lambda: himeno_stencil(*args), ValueError)

from repro_torch.configs import get_config, reduced, smoke_shape
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.kernel import (
    load_library as flash_library)
from repro_torch.kernels.rmsnorm import rms_norm
from repro_torch.kernels.rmsnorm.kernel import load_library as rms_library
from repro_torch.launch.serve import serve
from repro_torch.models import (
    init_decode_state, init_params, params_from_reference, synthetic_batch)
from repro_torch.runtime import ServingEngine

cfg = reduced(get_config("llama3.2-3b"))
raises(lambda: init_params(cfg), RuntimeError)
model = init_params(cfg, device="cpu")
raises(lambda: ServingEngine(cfg, model), RuntimeError)
raises(lambda: init_decode_state(cfg, 2, 8), RuntimeError)
raises(lambda: synthetic_batch(cfg, smoke_shape("prefill")), RuntimeError)
raises(lambda: params_from_reference(cfg, {}, None), RuntimeError)
raises(serve, RuntimeError)
raises(lambda: serve(adaptive=True), RuntimeError)
raises(rms_library, RuntimeError)
raises(flash_library, RuntimeError)
raises(lambda: rms_norm(torch.zeros(2, 64, device="meta"),
                        torch.ones(64, device="meta")), ValueError)
raises(lambda: flash_attention(*(torch.zeros(1, 2, 16, 16, device="meta"),)
                               * 3), ValueError)

from repro_torch.kernels.wkv import wkv
from repro_torch.kernels.wkv.kernel import load_library as wkv_library

rwkv = reduced(get_config("rwkv6-1.6b"))
raises(lambda: init_params(rwkv), RuntimeError)
raises(lambda: init_decode_state(rwkv, 2, 8), RuntimeError)
init_params(rwkv, device="cpu")
init_decode_state(rwkv, 2, 8, device="cpu")
raises(lambda: serve("rwkv6-1.6b"), RuntimeError)
raises(wkv_library, RuntimeError)
raises(lambda: wkv(*(torch.zeros(1, 2, 4, 16, device="meta"),) * 4,
                   torch.zeros(2, 16, device="meta")), ValueError)
from repro_torch.models import ssm
from repro_torch.models.transformer import decode_step, forward

zamba = reduced(get_config("zamba2-7b"))
raises(lambda: init_params(zamba), RuntimeError)
raises(lambda: init_decode_state(zamba, 2, 8), RuntimeError)
raises(lambda: serve("zamba2-7b"), RuntimeError)
hybrid = init_params(zamba, device="cpu")
st = init_decode_state(zamba, 2, 8, device="cpu")
decode_step(zamba, hybrid, st, torch.zeros(2, dtype=torch.int32))
forward(zamba, hybrid, {"tokens": torch.zeros(1, 4, dtype=torch.int64)})
ssm.init_ssm_state(zamba, 2, device="cpu")
raises(lambda: flash_attention(*(torch.zeros(1, 2, 16, 112, device="meta"),)
                               * 3), ValueError)
from repro_torch.models import moe

mixtral = reduced(get_config("mixtral-8x7b"))
raises(lambda: init_params(mixtral), RuntimeError)
raises(lambda: init_decode_state(mixtral, 2, 8), RuntimeError)
raises(lambda: serve("mixtral-8x7b"), RuntimeError)
moe_lm = init_params(mixtral, device="cpu")
st = init_decode_state(mixtral, 2, 8, device="cpu")
decode_step(mixtral, moe_lm, st, torch.zeros(2, dtype=torch.int32))
forward(mixtral, moe_lm, {"tokens": torch.zeros(1, 4, dtype=torch.int64)})
moe.moe_apply(mixtral, moe_lm.layers[0]["moe"], torch.zeros(1, 4, 64))

for arch, extra in (("seamless-m4t-medium", "frames"),
                    ("llava-next-mistral-7b", "patches")):
    small = reduced(get_config(arch))
    raises(lambda: init_params(small), RuntimeError)
    raises(lambda: init_decode_state(small, 2, 8), RuntimeError)
    raises(lambda: serve(arch), RuntimeError)
    lm = init_params(small, device="cpu")
    st = init_decode_state(small, 2, 8, device="cpu")
    decode_step(small, lm, st, torch.zeros(2, dtype=torch.int32))
    forward(small, lm, {"tokens": torch.zeros(1, 4, dtype=torch.int64),
                        extra: torch.zeros(1, 3, 64, dtype=torch.bfloat16)})
from repro_torch.runtime import Request, migrate, static_placements

engines = [ServingEngine(cfg, model, slots=2, max_len=16, device="cpu",
                         name=name) for name in ("a", "b")]
engines[0].submit(Request(rid=0, prompt=[1, 2], max_new_tokens=3))
for eng in engines:
    eng.stream_open()
engines[0].stream_step()
assert migrate(engines[0], engines[1], 0) == 0
engines[1].reconfigure(static_placements("llama3.2-3b",
                                         {"data": 16, "model": 16}))
from repro_torch.configs import mixed_fleet
from repro_torch.launch.serve import serve_fleet
from repro_torch.runtime import FleetRouter
from repro_torch.workload import TenantSpec, WorkloadSpec, generate, simulate

raises(serve_fleet, RuntimeError)
raises(lambda: serve_fleet(adaptive=True), RuntimeError)
raises(lambda: serve_fleet(provision_budget_w=50_000.0), RuntimeError)
raises(lambda: FleetRouter(cfg, model, mixed_fleet(), arch="llama3.2-3b",
                           cache_path=None), RuntimeError)
fleet = FleetRouter(cfg, model, mixed_fleet(), arch="llama3.2-3b",
                    cache_path=None, slots=2, max_len=16, device="cpu")
trace = generate(WorkloadSpec(seed=0, duration_s=0.004, rate_rps=1000.0,
                              max_len=16, tenants=(TenantSpec("t"),)))
report = simulate(fleet, trace, rebalance_every_s=0.001, rebalance_live=True)
assert report.completed == len(trace) > 0
done = fleet.run(concurrent=True)
from repro_torch.analysis import lint_runtime
from repro_torch.launch.steps import init_train_state
from repro_torch.launch.train import train

assert lint_runtime().findings == []
raises(lambda: init_train_state(cfg), RuntimeError)
raises(lambda: train(steps=1), RuntimeError)
out = train(steps=2, log_every=0, global_batch=2, seq_len=16, device="cpu")
assert out["steps"] == 2
print("ISOLATED", len(mods))
"""


def test_every_module_imports_without_jax_or_reference():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _SCRIPT, *MODULES],
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"ISOLATED {len(MODULES)}" in out.stdout


@pytest.mark.parametrize("module", MODULES)
def test_module_source_names_no_jax_or_reference(module):
    rel = Path(*module.split("."))
    path = PKG.parent / rel.with_suffix(".py")
    if not path.exists():
        path = PKG.parent / rel / "__init__.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (module, name)
