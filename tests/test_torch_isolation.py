"""The port stands alone: no module of ``repro_torch`` imports JAX or the
JAX package, and its entry points raise without CUDA instead of falling
back to the CPU."""
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
raises(rms_library, RuntimeError)
raises(flash_library, RuntimeError)
raises(lambda: rms_norm(torch.zeros(2, 64, device="meta"),
                        torch.ones(64, device="meta")), ValueError)
raises(lambda: flash_attention(*(torch.zeros(1, 2, 16, 16, device="meta"),)
                               * 3), ValueError)
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
