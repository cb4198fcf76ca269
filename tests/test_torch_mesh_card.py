"""The mesh train step on the card: ``build_train_step`` on a 1×1
("data", "model") mesh through kernels B2 and B3 and their gradients,
against the same step through their plain versions, and its launches.
Needs a CUDA card and skips elsewhere; the file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mesh_card.py

A 2-layer llama3.2-3b in f32 at d 256 (4 heads of 64, 2 KV heads), accum
2 over 4 rows of 128 tokens. Tolerances: the loss within 1e-5 relative,
the gradient (AdamW's first moment after the step over 1 - b1, the clip
the same in both) within 1e-4 of each leaf's max, the updated parameters
within 1e-4 of each leaf's max but for at most 1e-3 of a leaf's elements,
within 1e-2: AdamW's first step sends a gradient element near zero to
±lr, and the two runs' rounding may give it either sign.
"""
import dataclasses

import pytest
import torch

from repro_torch._tree import flatten
from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.data import SyntheticLMStream, device_put_batch
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_backward_cuda, flash_attention_cuda)
from repro_torch.kernels.rmsnorm import rms_norm_ref
from repro_torch.kernels.rmsnorm.kernel import (rms_norm_backward_cuda,
                                                rms_norm_cuda)
from repro_torch.launch import mesh as MESH
from repro_torch.launch.steps import build_train_step, init_train_state, \
    place
from repro_torch.models import attention as attn
from repro_torch.models import layers as ML
from repro_torch.parallel.layouts import rules_for
from repro_torch.parallel.sharding import full, use_mesh

pytestmark = pytest.mark.cuda

ACCUM = 2


@pytest.fixture
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m = MESH.make_mesh_compat((1, 1), ("data", "model"))
    yield m
    MESH.release_process_group()


def _cfg():
    return dataclasses.replace(
        reduced(get_config("llama3.2-3b")), num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=2048,
        dtype="float32", accum=ACCUM)


def _step(cfg, mesh):
    shape = ShapeSpec("t", "train", 128, 4)
    rules = rules_for(cfg, shape, mesh)
    prog = build_train_step(cfg, shape, mesh, rules)
    state = place(init_train_state(cfg, device="cuda"), prog.in_shardings[0])
    batch = device_put_batch(SyntheticLMStream(cfg, shape).batch_at(0),
                             "cuda")
    with use_mesh(mesh, rules):
        state, metrics = prog.jitted()(state, batch)
    torch.cuda.synchronize()
    return ({k: [full(v) for _, v in flatten(state[k] if k == "params"
                                              else state["opt"][k])]
             for k in ("params", "m")},
            {k: float(v) for k, v in metrics.items()})


def test_mesh_train_step_matches_the_plain_versions(mesh, monkeypatch):
    cfg = _cfg()
    counts = (rms_norm_cuda.launches, rms_norm_backward_cuda.launches,
              flash_attention_cuda.launches,
              flash_attention_backward_cuda.launches)
    got, gm = _step(cfg, mesh)
    n = cfg.num_layers
    # remat full, per microbatch: 2n+1 norms and n attentions forward, the
    # 2n norms and n attentions again in the recompute; B2's gradient a
    # norm of the forward, B3's backward an attention
    want_n = (4 * n + 1, 2 * n + 1, 2 * n, n)
    after = (rms_norm_cuda.launches, rms_norm_backward_cuda.launches,
             flash_attention_cuda.launches,
             flash_attention_backward_cuda.launches)
    assert tuple(a - b for a, b in zip(after, counts)) == tuple(
        ACCUM * k for k in want_n)

    monkeypatch.setattr(ML, "_rms_norm_op", rms_norm_ref)
    monkeypatch.setattr(attn, "flash_attention",
                        lambda q, k, v, causal, window, q_offset=0:
                        attention_ref(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset))
    want, wm = _step(cfg, mesh)
    assert rms_norm_cuda.launches == after[0]  # the plain versions ran
    assert gm["loss"] == pytest.approx(wm["loss"], rel=1e-5)
    assert gm["grad_norm"] == pytest.approx(wm["grad_norm"], rel=1e-4)
    for a, b in zip(got["m"], want["m"]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    for a, b in zip(got["params"], want["params"]):
        err = (a - b).abs() / b.abs().max().clamp_min(1e-30)
        assert float((err > 1e-4).float().mean()) <= 1e-3
        assert float(err.max()) <= 1e-2
