"""The fleet on the card. These need a CUDA card and skip elsewhere; the file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fleet_card.py

A reduced bf16 llama3.2-3b is shared by the engines of a mixed fleet on the
card. ``FleetRouter.run(concurrent=True)`` steps them on worker threads:
its tokens, finish reasons and every ``EngineStats`` field must equal the
single-worker run's and the sequential drain's, and RMSNorm (B2) must be
launched exactly 2n+1 times a step of every engine, threads or not. The
modeled ledger must equal the same fleet's on the CPU, and a replay with
live rebalancing must keep the moved requests' tokens.
"""
import dataclasses
import tempfile

import pytest
import torch

from repro_torch import models as M
from repro_torch.configs import get_config, mixed_fleet, reduced
from repro_torch.kernels.rmsnorm import rms_norm_cuda
from repro_torch.launch.serve import serve_fleet
from repro_torch.runtime import FleetRouter, Request, ServingEngine
from repro_torch.workload import TenantSpec, WorkloadSpec, generate, simulate

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _model(device="cuda"):
    cfg = reduced(get_config("llama3.2-3b"))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return cfg, M.init_params(cfg, gen)


def _requests():
    return [Request(rid=i, prompt=[1 + i % 7, 2, 3 + i % 5],
                    max_new_tokens=6 + i % 4) for i in range(9)]


def _run(cfg, model, device="cuda", **run):
    router = FleetRouter(cfg, model, mixed_fleet(), arch="llama3.2-3b",
                         policy="round_robin", slots=2, max_len=32,
                         cache_path=None, device=device)
    for r in _requests():
        router.submit(r)
    before = rms_norm_cuda.launches
    done = router.run(**run)
    torch.cuda.synchronize()
    outputs = [(r.rid, tuple(r.output), r.finish_reason, r.served_by)
               for r in done]
    ledgers = {n: dataclasses.asdict(s)
               for n, s in router.per_engine_stats().items()}
    return outputs, ledgers, rms_norm_cuda.launches - before


def test_concurrent_fleet_matches_sequential_and_counts_every_launch():
    cfg, model = _model()
    per_step = 2 * cfg.num_layers + 1
    seq = _run(cfg, model)
    one = _run(cfg, model, concurrent=True, max_workers=1)
    wide = _run(cfg, model, concurrent=True)
    assert wide[:2] == one[:2] == seq[:2]
    steps = sum(s["steps"] for s in seq[1].values())
    assert steps > 0
    for outputs, ledgers, launches in (seq, one, wide):
        assert launches == per_step * steps
        assert len(outputs) == 9


def test_card_ledger_equals_the_cpu_fleet_ledger():
    """No request carries an eos, so the modeled ledger does not depend on
    token values: the card's equals the CPU's field by field."""
    cfg, model = _model()
    _, card, _ = _run(cfg, model, concurrent=True)
    cfg_cpu, model_cpu = _model("cpu")
    _, cpu, _ = _run(cfg_cpu, model_cpu, device="cpu", concurrent=True)
    assert card == cpu


def test_serve_fleet_report_on_the_card_matches_the_cpu():
    timed = {"wall_s", "tokens_per_s", "outputs", "device"}
    with tempfile.TemporaryDirectory() as tmp:
        got = serve_fleet(num_requests=4, max_new_tokens=6, adaptive=True,
                          device="cuda", cache_path=f"{tmp}/card.jsonl")
        want = serve_fleet(num_requests=4, max_new_tokens=6, adaptive=True,
                           device="cpu", cache_path=f"{tmp}/cpu.jsonl")
    assert got["device"].startswith("cuda")
    assert {k: v for k, v in got.items() if k not in timed} \
        == {k: v for k, v in want.items() if k not in timed}


def test_replay_moves_live_slots_and_keeps_their_tokens():
    cfg, model = _model()
    tenants = (TenantSpec("chat", weight=3.0, prompt_median=6,
                          prompt_max=14, new_tokens_median=4,
                          new_tokens_max=8, slo_s=0.05),
               TenantSpec("batch", weight=1.0, prompt_median=10,
                          prompt_max=20, new_tokens_median=6,
                          new_tokens_max=10))
    trace = generate(WorkloadSpec(seed=0, duration_s=0.012, rate_rps=2400.0,
                                  max_len=64, arrival="bursty",
                                  tenants=tenants))
    router = FleetRouter(cfg, model, mixed_fleet(), arch="llama3.2-3b",
                         slots=2, max_len=64, cache_path=None,
                         autoscale=True, saturation_factor=1.0,
                         device="cuda")
    report = simulate(router, trace, autoscale_every_s=0.002,
                      rebalance_every_s=0.001, rebalance_live=True)
    assert report.migrations >= 1
    assert report.completed == len(trace)
    solo = ServingEngine(cfg, model, slots=2, max_len=64, device="cuda")
    fresh = [Request(rid=t.rid, prompt=list(t.request.prompt),
                     max_new_tokens=t.request.max_new_tokens)
             for t in trace]
    for r in fresh:
        solo.submit(r)
    solo.run()
    assert [tuple(r.output) for r in fresh] \
        == [tuple(t.request.output) for t in trace]
