"""The port's ServingEngine against the JAX package's, on the CPU.

The scenarios of ``tests/test_slot_stream.py`` (ragged lengths, finish
reasons, the length cap, placement-epoch attribution, energy correction,
SLO-aware admission, a mid-run submit) run through both packages on the
same weights (the reduced llama3.2-3b at float32, drawn by the reference's
``init_params`` and carried across), under both schedulers. The greedy
outputs must be token-identical and every field of ``EngineStats`` equal.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import models as RM
from repro import runtime as RR
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro_torch import models as M
from repro_torch import runtime as PR
from repro_torch.configs import get_config, reduced
from repro_torch.launch.serve import serve


@functools.lru_cache(maxsize=None)
def _models():
    rcfg = dataclasses.replace(ref_reduced(ref_get_config("llama3.2-3b")),
                               dtype="float32")
    cfg = dataclasses.replace(reduced(get_config("llama3.2-3b")),
                              dtype="float32")
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    model = M.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    "cpu")
    return {RR: (rcfg, params), PR: (cfg, model)}


def _engine(pkg, **kw):
    cfg, weights = _models()[pkg]
    if pkg is PR:
        kw["device"] = "cpu"
    return pkg.ServingEngine(cfg, weights, **kw)


def _ragged(pkg, n=6):
    """Deliberately ragged lengths: the wave scheduler idles slots on these."""
    return [pkg.Request(rid=i, prompt=[1 + (i + j) % 11
                                       for j in range(2 + (i * 5) % 13)],
                        max_new_tokens=1 + (i * 3) % 7)
            for i in range(n)]


def _placement(pkg, kind, e, t=0.0):
    return pkg.Placement(kind=kind, cell="c", destination="d",
                         decisions=None, clock=1.0, energy_per_token_ws=e,
                         time_per_token_s=t)


# Each scenario builds an engine in one package, feeds it and returns it
# with its finished requests: (pkg, scheduler) -> (engine, done).

def _ragged_six(pkg, scheduler):
    eng = _engine(pkg, slots=3, max_len=32, scheduler=scheduler)
    for r in _ragged(pkg, 6):
        eng.submit(r)
    return eng, eng.run()


def _ragged_five(pkg, scheduler):
    eng = _engine(pkg, slots=2, max_len=24, scheduler=scheduler)
    for r in _ragged(pkg, 5):
        eng.submit(r)
    return eng, eng.run()


def _length_cap(pkg, scheduler):
    eng = _engine(pkg, slots=1, max_len=16, scheduler=scheduler)
    eng.submit(pkg.Request(rid=0, prompt=list(range(1, 11)),
                           max_new_tokens=32))
    return eng, eng.run()


def _max_new_then_eos(pkg, scheduler):
    eng = _engine(pkg, slots=1, max_len=32, scheduler=scheduler)
    eng.submit(pkg.Request(rid=0, prompt=[3, 4], max_new_tokens=3))
    first = eng.run()[0].output[0]
    eng.submit(pkg.Request(rid=1, prompt=[3, 4], max_new_tokens=3,
                           eos_id=first))
    eng.submit(pkg.Request(rid=2, prompt=[5, 6, 7], max_new_tokens=4))
    return eng, eng.run()


def _epoch_swap(pkg, scheduler):
    eng = _engine(pkg, slots=1, max_len=32, scheduler=scheduler)
    eng.reconfigure({"prefill": _placement(pkg, "prefill", 2.0),
                     "decode": _placement(pkg, "decode", 1.0)})
    epoch_b = {"prefill": _placement(pkg, "prefill", 20.0),
               "decode": _placement(pkg, "decode", 10.0)}

    def swap_early(engine):
        if engine.stats.steps == 1:
            engine.reconfigure(epoch_b)

    eng.on_step_end = swap_early
    eng.submit(pkg.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=3))
    eng.submit(pkg.Request(rid=1, prompt=[4, 5], max_new_tokens=2))
    return eng, eng.run()


def _energy_correction(pkg, scheduler):
    eng = _engine(pkg, slots=1, max_len=32, scheduler=scheduler)
    eng.reconfigure({"prefill": _placement(pkg, "prefill", 2.0),
                     "decode": _placement(pkg, "decode", 1.0)})
    eng.energy_correction["decode"] = 2.0
    eng.submit(pkg.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=3))
    return eng, eng.run()


def _slo_admission(pkg, scheduler):
    eng = _engine(pkg, slots=2, max_len=32, scheduler=scheduler)
    eng.reconfigure({"prefill": _placement(pkg, "prefill", 1.0, t=0.1),
                     "decode": _placement(pkg, "decode", 1.0, t=0.2)})
    eng.submit(pkg.Request(rid=0, prompt=[1, 2, 3, 4], max_new_tokens=3,
                           slo_s=10.0))
    eng.submit(pkg.Request(rid=1, prompt=[5, 6, 7, 8], max_new_tokens=3,
                           slo_s=0.5))
    return eng, eng.run()


def _mid_run_submit(pkg, scheduler):
    eng = _engine(pkg, slots=2, max_len=32, scheduler=scheduler)
    late = pkg.Request(rid=99, prompt=[7, 8], max_new_tokens=2)

    def submit_late(engine):
        if engine.stats.steps == 2 and late.status == "queued":
            engine.submit(late)

    eng.on_step_end = submit_late
    eng.submit(pkg.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=4))
    eng.submit(pkg.Request(rid=1, prompt=[4, 5, 6, 7, 8, 9, 10, 11],
                           max_new_tokens=2))
    return eng, eng.run()


def _overflow_truncate(pkg, scheduler):
    eng = _engine(pkg, slots=2, max_len=12, scheduler=scheduler,
                  overflow="truncate")
    eng.submit(pkg.Request(rid=0, prompt=list(range(1, 20)),
                           max_new_tokens=4))
    eng.submit(pkg.Request(rid=1, prompt=[], max_new_tokens=4))
    eng.submit(pkg.Request(rid=2, prompt=[2, 3], max_new_tokens=5))
    return eng, eng.run()


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _ragged_six, _ragged_five, _length_cap, _max_new_then_eos, _epoch_swap,
    _energy_correction, _slo_admission, _mid_run_submit, _overflow_truncate)}


def _record(eng, done):
    reqs = [(r.rid, r.output, r.status, r.finish_reason, r.truncated_tokens,
             r.modeled_latency_s, r.served_by, r.destination) for r in done]
    return reqs, dataclasses.asdict(eng.stats)


@pytest.mark.parametrize("scheduler", ["stream", "wave"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_engine_matches_reference(scenario, scheduler):
    ref_reqs, ref_stats = _record(*SCENARIOS[scenario](RR, scheduler))
    reqs, stats = _record(*SCENARIOS[scenario](PR, scheduler))
    assert reqs == ref_reqs
    assert stats == ref_stats
    assert reqs  # every scenario finishes something


@pytest.mark.parametrize("n,slots,max_len", [(5, 2, 24), (8, 3, 32)])
def test_stream_matches_wave_in_the_port(n, slots, max_len):
    out = {}
    for scheduler in ("stream", "wave"):
        eng = _engine(PR, slots=slots, max_len=max_len, scheduler=scheduler)
        for r in _ragged(PR, n):
            eng.submit(r)
        out[scheduler] = ({r.rid: r.output for r in eng.run()}, eng.stats)
    assert out["stream"][0] == out["wave"][0]
    assert len(out["stream"][0]) == n
    stream, wave = out["stream"][1], out["wave"][1]
    assert stream.total_tokens == wave.total_tokens
    assert stream.steps <= wave.steps


def test_large_queue_drains_in_order():
    """FIFO admission under a stubbed step, as in the reference's test."""
    cfg, _ = _models()[PR]
    eng = PR.ServingEngine(cfg, None, slots=8, max_len=8, device="cpu")
    eng._step = lambda model, state, tokens: (
        torch.zeros((tokens.shape[0], 8)), state)
    for i in range(800):
        eng.submit(PR.Request(rid=i, prompt=[1], max_new_tokens=1))
    done = eng.run(max_steps=800)
    assert [r.rid for r in done] == list(range(800))
    assert eng.stats.steps == 100 and eng.stats.occupancy == 1.0


def test_engine_refuses_a_model_on_another_device():
    cfg, model = _models()[PR]
    with pytest.raises(ValueError, match="lies on cpu"):
        PR.ServingEngine(cfg, model, device="meta")


def test_serve_on_cpu_completes_every_request():
    out = serve("llama3.2-3b", num_requests=5, slots=2, max_new_tokens=4,
                device="cpu")
    assert out["completed"] == 5 and out["rejected"] == 0
    assert out["decode_tokens"] == 5 * 3  # the first token rides on prefill
    assert all(len(o) == 4 for o in out["outputs"].values())
    assert out["energy_ws"] == 0.0 and "slice 4" in out["energy_note"]
    with pytest.raises(NotImplementedError, match="slice 4"):
        serve("llama3.2-3b", adaptive=True, device="cpu")
