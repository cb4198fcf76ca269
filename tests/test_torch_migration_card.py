"""Mid-flight slot migration and placement on the card. These need a CUDA
card and skip elsewhere; the file imports no JAX, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_migration_card.py

A slot of a small bf16 llama (or rwkv, through B4) moves between two
engines that share one model on the card, at admission, mid-decode and one
token before its end. At equal geometry each row's arithmetic is the same
kernels on the same shapes, so tokens and finish reasons must equal the
never-migrated baseline's exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch import models as M
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.rmsnorm import rms_norm_cuda
from repro_torch.kernels.wkv import wkv_cuda
from repro_torch.launch.serve import serve
from repro_torch.runtime import Request, ServingEngine, migrate

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _model(arch):
    cfg = reduced(get_config(arch))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return cfg, M.init_params(cfg, gen)


def _requests():
    return [Request(rid=i, prompt=[1 + i % 7, 2, 3 + i % 5],
                    max_new_tokens=8 + i % 3) for i in range(6)]


def _record(rs):
    return {r.rid: (tuple(r.output), r.finish_reason) for r in rs}


def _run(cfg, model, moves, dst_max_len=32):
    """Serve the set on engine A (index 0) with B (index 1) beside it;
    ``moves`` are (rid, from, to, when(request)), each fired once, in
    order, before the first round its request sits in ``from`` and
    ``when`` holds. Returns the record and both engines."""
    engines = [ServingEngine(cfg, model, slots=2, max_len=32, name="a"),
               ServingEngine(cfg, model, slots=2, max_len=dst_max_len,
                             name="b")]
    rs = _requests()
    for r in rs:
        engines[0].submit(r)
    for e in engines:
        e.stream_open()
    pending = list(moves)
    for _ in range(400):
        for move in list(pending):
            rid, src, dst, when = move
            slot_req = engines[src]._stream["slot_req"]
            if rs[rid] in slot_req and when(rs[rid]):
                migrate(engines[src], engines[dst], slot_req.index(rs[rid]))
                pending.remove(move)
        outs = [e.stream_step() for e in engines]
        if all(o is None for o in outs):
            break
    for e in engines:
        e.stream_close()
    assert not pending
    return _record(rs), engines


def _half(r):
    return len(r.output) == r.max_new_tokens // 2


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-1.6b"])
def test_migrated_tokens_equal_the_baseline_on_the_card(arch):
    cfg, model = _model(arch)
    base, _ = _run(cfg, model, ())
    # rid 0: after its admission, back mid-decode (into the slot rid 1
    # leaves just before: A's queue refills a freed slot at its next step)
    # and one token before its end
    moves = [(0, 0, 1, lambda r: True), (1, 0, 1, _half), (0, 1, 0, _half),
             (0, 0, 1, lambda r: len(r.output) == r.max_new_tokens - 1)]
    n2, n4 = rms_norm_cuda.launches, wkv_cuda.launches
    got, (a, b) = _run(cfg, model, moves)
    torch.cuda.synchronize()
    assert got == base
    assert a.stats.migrations_out + b.stats.migrations_out \
        == a.stats.migrations_in + b.stats.migrations_in == 4
    steps = a.stats.steps + b.stats.steps
    assert rms_norm_cuda.launches - n2 == steps * (2 * cfg.num_layers + 1)
    if cfg.family == "ssm":
        assert wkv_cuda.launches - n4 == steps * cfg.num_layers


def test_resized_move_keeps_its_tokens_on_the_card():
    cfg, model = _model("llama3.2-3b")
    base, _ = _run(cfg, model, ())
    got, (a, b) = _run(cfg, model, [(0, 0, 1, _half)], dst_max_len=24)
    assert b.stats.migrations_in == 1
    assert got == base


def test_snapshot_is_a_host_copy():
    cfg, model = _model("llama3.2-3b")
    eng = ServingEngine(cfg, model, slots=2, max_len=32)
    eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=6))
    eng.stream_open()
    for _ in range(3):
        eng.stream_step()
    snap = eng.snapshot_slot(0)
    live = eng._stream["state"]["kv"]["k"][:, 0]
    assert snap.leaves["kv"]["k"].device.type == "cpu"
    assert torch.equal(snap.leaves["kv"]["k"], live.cpu())
    assert snap.nbytes == sum(v.numel() * v.element_size()
                              for v in snap.leaves["kv"].values())
    eng.stream_close()


def test_serve_applies_placements_on_the_card(tmp_path):
    out = serve("llama3.2-3b", num_requests=8, slots=4, max_new_tokens=8)
    assert out["energy_ws"] > 0.0 and out["device"].startswith("cuda")
    adaptive = serve("llama3.2-3b", num_requests=8, slots=4,
                     max_new_tokens=8, adaptive=True,
                     cache_path=str(tmp_path / "cache.jsonl"))
    assert adaptive["outputs"] == out["outputs"]
    assert adaptive["new_measurements"] > 0
    assert np.isfinite(adaptive["ws_per_1k_tokens"])
