"""The port's ServingEngine against the JAX package's, on the CPU.

The scenarios of ``tests/test_slot_stream.py`` (ragged lengths, finish
reasons, the length cap, placement-epoch attribution, energy correction,
SLO-aware admission, a mid-run submit) run through both packages on the
same weights (the reduced llama3.2-3b, rwkv6-1.6b, zamba2-7b,
mixtral-8x7b, seamless-m4t-medium and llava-next-mistral-7b, at float32,
drawn by the reference's ``init_params`` and carried across), under both
schedulers. Requests are tokens only: the enc-dec decoder attends to the
state's ``cross_k``/``cross_v``, zeros that admission resets, and the VLM
serves its dense block on tokens, as in the reference. The greedy outputs must be
token-identical and every field of ``EngineStats`` equal. zamba2 runs at 5 layers, two groups and a tail
(its stock reduced config has no tail).

In bfloat16 the two packages round at other places, so a greedy choice
between two logits closer than that rounding could part.
``test_bf16_greedy_tokens_match_reference`` holds greedy decode and the
ragged scenarios of all six families in bf16 to identical tokens; where a
run parts, the first parting step must be a bf16 near-tie: every token
before it identical, both packages' logits within 2e-2 of max |logits|
there, and the reference's own margin between the two choices within that
tolerance. An MoE router turns a bf16 rounding at a near-tie into another
expert for one token, and that token's logits then part by more than the
tolerance: for mixtral-8x7b, logits may part first at a step where some
layer of a parting row chose other experts in the two packages, the first
such choice a bf16 near-tie of the reference's router probabilities, within
the same tolerance of its largest.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as RM
from repro import runtime as RR
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import moe as ref_moe
from repro_torch import models as M
from repro_torch import runtime as PR
from repro_torch.configs import get_config, reduced
from repro_torch.launch.serve import serve
from repro_torch.models import moe as port_moe


DENSE, RWKV, HYBRID, MOE = ("llama3.2-3b", "rwkv6-1.6b", "zamba2-7b",
                             "mixtral-8x7b")
ENCDEC, VLM = "seamless-m4t-medium", "llava-next-mistral-7b"
# changes to the reduced config beside the dtype: zamba2 with a tail
CHANGES = {HYBRID: {"num_layers": 5}}
BF16_TOL = 2e-2


@functools.lru_cache(maxsize=None)
def _models(arch=DENSE, dtype="float32"):
    changes = dict(CHANGES.get(arch, {}), dtype=dtype)
    rcfg = dataclasses.replace(ref_reduced(ref_get_config(arch)), **changes)
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    model = M.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    "cpu")
    return {RR: (rcfg, params), PR: (cfg, model)}


def _engine(pkg, arch=DENSE, **kw):
    """``arch`` names the reduced config, in float32, or is (name, dtype)
    or (name, dtype, log): then every decode step's tokens and logits are
    appended to the list ``log``."""
    name, dtype, *log = (arch, "float32") if isinstance(arch, str) else arch
    cfg, weights = _models(name, dtype)[pkg]
    if pkg is PR:
        kw["device"] = "cpu"
    eng = pkg.ServingEngine(cfg, weights, **kw)
    return _logged(eng, log[0]) if log else eng


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

def _ragged_six(pkg, scheduler, arch=DENSE):
    eng = _engine(pkg, arch, slots=3, max_len=32, scheduler=scheduler)
    for r in _ragged(pkg, 6):
        eng.submit(r)
    return eng, eng.run()


def _ragged_five(pkg, scheduler, arch=DENSE):
    eng = _engine(pkg, arch, slots=2, max_len=24, scheduler=scheduler)
    for r in _ragged(pkg, 5):
        eng.submit(r)
    return eng, eng.run()


def _length_cap(pkg, scheduler, arch=DENSE):
    eng = _engine(pkg, arch, slots=1, max_len=16, scheduler=scheduler)
    eng.submit(pkg.Request(rid=0, prompt=list(range(1, 11)),
                           max_new_tokens=32))
    return eng, eng.run()


def _max_new_then_eos(pkg, scheduler, arch=DENSE):
    eng = _engine(pkg, arch, slots=1, max_len=32, scheduler=scheduler)
    eng.submit(pkg.Request(rid=0, prompt=[3, 4], max_new_tokens=3))
    first = eng.run()[0].output[0]
    eng.submit(pkg.Request(rid=1, prompt=[3, 4], max_new_tokens=3,
                           eos_id=first))
    eng.submit(pkg.Request(rid=2, prompt=[5, 6, 7], max_new_tokens=4))
    return eng, eng.run()


def _epoch_swap(pkg, scheduler, arch=DENSE):
    eng = _engine(pkg, arch, slots=1, max_len=32, scheduler=scheduler)
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


def _energy_correction(pkg, scheduler, arch=DENSE):
    eng = _engine(pkg, arch, slots=1, max_len=32, scheduler=scheduler)
    eng.reconfigure({"prefill": _placement(pkg, "prefill", 2.0),
                     "decode": _placement(pkg, "decode", 1.0)})
    eng.energy_correction["decode"] = 2.0
    eng.submit(pkg.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=3))
    return eng, eng.run()


def _slo_admission(pkg, scheduler, arch=DENSE):
    eng = _engine(pkg, arch, slots=2, max_len=32, scheduler=scheduler)
    eng.reconfigure({"prefill": _placement(pkg, "prefill", 1.0, t=0.1),
                     "decode": _placement(pkg, "decode", 1.0, t=0.2)})
    eng.submit(pkg.Request(rid=0, prompt=[1, 2, 3, 4], max_new_tokens=3,
                           slo_s=10.0))
    eng.submit(pkg.Request(rid=1, prompt=[5, 6, 7, 8], max_new_tokens=3,
                           slo_s=0.5))
    return eng, eng.run()


def _mid_run_submit(pkg, scheduler, arch=DENSE):
    eng = _engine(pkg, arch, slots=2, max_len=32, scheduler=scheduler)
    late = pkg.Request(rid=99, prompt=[7, 8], max_new_tokens=2)

    def submit_late(engine):
        if engine.stats.steps == 2 and late.status == "queued":
            engine.submit(late)

    eng.on_step_end = submit_late
    eng.submit(pkg.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=4))
    eng.submit(pkg.Request(rid=1, prompt=[4, 5, 6, 7, 8, 9, 10, 11],
                           max_new_tokens=2))
    return eng, eng.run()


def _overflow_truncate(pkg, scheduler, arch=DENSE):
    eng = _engine(pkg, arch, slots=2, max_len=12, scheduler=scheduler,
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


@pytest.mark.parametrize("scheduler", ["stream", "wave"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_rwkv_engine_matches_reference(scenario, scheduler):
    """The same scenarios on the recurrent family, whose slots carry their
    history in the decode state that admission resets."""
    ref_reqs, ref_stats = _record(*SCENARIOS[scenario](RR, scheduler, RWKV))
    reqs, stats = _record(*SCENARIOS[scenario](PR, scheduler, RWKV))
    assert reqs == ref_reqs
    assert stats == ref_stats
    assert reqs


@pytest.mark.parametrize("scheduler", ["stream", "wave"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_hybrid_engine_matches_reference(scenario, scheduler):
    """The same scenarios on the hybrid family (Mamba state reset at
    admission, the shared attention's KV caches left alone)."""
    ref_reqs, ref_stats = _record(*SCENARIOS[scenario](RR, scheduler,
                                                       HYBRID))
    reqs, stats = _record(*SCENARIOS[scenario](PR, scheduler, HYBRID))
    assert reqs == ref_reqs
    assert stats == ref_stats
    assert reqs


@pytest.mark.parametrize("scheduler", ["stream", "wave"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_moe_engine_matches_reference(scenario, scheduler):
    """The same scenarios on the MoE family: each slot's token routes to
    its experts within its own row, whatever the other slots hold."""
    ref_reqs, ref_stats = _record(*SCENARIOS[scenario](RR, scheduler, MOE))
    reqs, stats = _record(*SCENARIOS[scenario](PR, scheduler, MOE))
    assert reqs == ref_reqs
    assert stats == ref_stats
    assert reqs


@pytest.mark.parametrize("scheduler", ["stream", "wave"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_encdec_and_vlm_engines_match_reference(arch, scenario, scheduler):
    """The same scenarios on the enc-dec family (its memory leaves reset
    at admission) and on the VLM (the dense block on tokens)."""
    ref_reqs, ref_stats = _record(*SCENARIOS[scenario](RR, scheduler, arch))
    reqs, stats = _record(*SCENARIOS[scenario](PR, scheduler, arch))
    assert reqs == ref_reqs
    assert stats == ref_stats
    assert reqs


def _host(x, dtype):
    """A step's tokens or logits as a numpy array, from either package."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32 if dtype == np.float32 else torch.int64
                    ).numpy()
    return np.asarray(x).astype(dtype)


def _logged(eng, log):
    """Record (tokens, logits) of every decode step of ``eng``."""
    step = eng._step

    def logged_step(weights, state, tokens):
        logits, state = step(weights, state, tokens)
        log.append((_host(tokens, np.int64), _host(logits, np.float32)))
        return logits, state

    eng._step = logged_step
    return eng


def _first_parting(ref_log, log, routes=None):
    """The first step whose greedy choices part, checked to be a bf16
    near-tie after identical inputs; None if no step parts. With ``routes``
    (an MoE's router choices, ``_log_routes``), the first step whose logits
    part beyond the tolerance may instead follow a router near-tie."""
    for t, ((ref_toks, ref), (toks, out)) in enumerate(zip(ref_log, log)):
        assert np.array_equal(toks, ref_toks), f"inputs part at step {t}"
        ref_pick, pick = ref.argmax(-1), out.argmax(-1)
        scale = np.abs(ref).max()
        apart = np.abs(out - ref).max(-1) > BF16_TOL * scale
        if routes is not None and apart.any():
            layers = len(routes[RR]) // len(ref_log)
            _router_near_tie(routes, layers, t, np.nonzero(apart)[0])
            return t
        if np.array_equal(ref_pick, pick):
            continue
        assert np.abs(out - ref).max() <= BF16_TOL * scale, t
        rows = np.nonzero(ref_pick != pick)[0]
        margin = ref[rows, ref_pick[rows]] - ref[rows, pick[rows]]
        assert (margin <= BF16_TOL * scale).all(), (t, margin / scale)
        return t
    return None


def _log_routes(monkeypatch, routes):
    """Record (expert ids, router probabilities) of every ``route`` call in
    both packages, in order: one a layer a decode step."""
    ref_route, port_route = ref_moe.route, port_moe.route

    def ref_logged(cfg, p, x):
        w, ids, aux = ref_route(cfg, p, x)
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], -1)
        jax.debug.callback(lambda i, pr: routes[RR].append(
            (np.asarray(i), np.asarray(pr))), ids, probs, ordered=True)
        return w, ids, aux

    def port_logged(cfg, p, x):
        w, ids, aux = port_route(cfg, p, x)
        probs = torch.softmax(x.float() @ p["router"], -1)
        routes[PR].append((ids.numpy(), probs.numpy()))
        return w, ids, aux

    monkeypatch.setattr(ref_moe, "route", ref_logged)
    monkeypatch.setattr(port_moe, "route", port_logged)


def _router_near_tie(routes, layers, step, rows):
    """Some layer of each of ``rows`` chose other experts in the two
    packages at or before ``step``; the first such choice a near-tie of the
    reference's router: the probability of each expert only it chose
    exceeds that of each expert only the port chose by at most BF16_TOL of
    its largest."""
    for row in rows:
        for i in range((step + 1) * layers):
            (ref_ids, probs), (ids, _) = routes[RR][i], routes[PR][i]
            ref_set, port_set = set(ref_ids[row, 0]), set(ids[row, 0])
            if ref_set == port_set:
                continue
            p = probs[row, 0]
            margin = (min(p[e] for e in ref_set - port_set)
                      - max(p[e] for e in port_set - ref_set))
            assert 0 <= margin <= BF16_TOL * p.max(), (step, row, i, margin)
            break
        else:
            raise AssertionError(f"logits of row {row} part at step {step} "
                                 "with no router choice parted")


def _greedy(pkg, arch, log, prompt_len=6, new_tokens=16):
    """Three prompts teacher-forced through ``decode_step``, then greedy
    decode; returns the generated tokens, (3, new_tokens)."""
    cfg, weights = _models(arch, "bfloat16")[pkg]
    prompts = np.random.default_rng(11).integers(
        1, cfg.vocab_size, (3, prompt_len), dtype=np.int32)
    if pkg is PR:
        state = M.init_decode_state(cfg, 3, 32, device="cpu")
        step = functools.partial(M.decode_step, cfg)
        tok = torch.from_numpy
    else:
        state = RM.init_decode_state(cfg, 3, 32)
        step = jax.jit(functools.partial(RM.decode_step, cfg))
        tok = jnp.asarray
    eng = _logged(type("Steps", (), {"_step": staticmethod(step)})(), log)
    out = []
    nxt = prompts[:, 0]
    for t in range(prompt_len - 1 + new_tokens):
        logits, state = eng._step(weights, state, tok(nxt))
        pick = log[-1][1].argmax(-1).astype(np.int32)
        nxt = prompts[:, t + 1] if t + 1 < prompt_len else pick
        if t + 1 >= prompt_len:
            out.append(pick)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("run", ["greedy", *(
    f"{scenario}-{scheduler}" for scenario in ("ragged_six", "ragged_five")
    for scheduler in ("stream", "wave"))])
@pytest.mark.parametrize("arch", [DENSE, RWKV, HYBRID, MOE, ENCDEC, VLM])
def test_bf16_greedy_tokens_match_reference(arch, run, monkeypatch):
    """bf16 greedy tokens of both packages on the same weights and prompts:
    identical, or parted first at a bf16 near-tie (the module docstring)."""
    logs = {RR: [], PR: []}
    routes = None
    if arch == MOE:
        routes = {RR: [], PR: []}
        _log_routes(monkeypatch, routes)
    if run == "greedy":
        out = {pkg: _greedy(pkg, arch, logs[pkg]) for pkg in (RR, PR)}
        same = np.array_equal(out[RR], out[PR])
        stats_same = True
    else:
        scenario, scheduler = run.rsplit("-", 1)
        rec = {}
        for pkg in (RR, PR):
            eng, done = SCENARIOS[scenario](pkg, scheduler,
                                            (arch, "bfloat16", logs[pkg]))
            assert eng.stats.steps == len(logs[pkg])
            rec[pkg] = _record(eng, done)
        same = rec[RR][0] == rec[PR][0]
        stats_same = rec[RR][1] == rec[PR][1]
    if routes is not None:
        layers = _models(arch, "bfloat16")[PR][0].num_layers
        assert len(routes[RR]) == len(routes[PR]) == layers * len(logs[RR])
    if same:
        assert stats_same
        return
    assert _first_parting(logs[RR], logs[PR], routes) is not None


@pytest.mark.parametrize("n,slots,max_len", [(5, 2, 24), (8, 3, 32)])
def test_stream_matches_wave_in_the_port(n, slots, max_len):
    _stream_matches_wave(DENSE, n, slots, max_len)


def test_rwkv_stream_matches_wave_in_the_port():
    _stream_matches_wave(RWKV, 8, 3, 32)


def test_hybrid_stream_matches_wave_in_the_port():
    _stream_matches_wave(HYBRID, 8, 3, 32)


def test_moe_stream_matches_wave_in_the_port():
    _stream_matches_wave(MOE, 8, 3, 32)


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_encdec_and_vlm_stream_matches_wave_in_the_port(arch):
    _stream_matches_wave(arch, 8, 3, 32)


def _stream_matches_wave(arch, n, slots, max_len):
    out = {}
    for scheduler in ("stream", "wave"):
        eng = _engine(PR, arch, slots=slots, max_len=max_len,
                      scheduler=scheduler)
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


def test_serve_on_cpu_completes_every_request(tmp_path):
    """serve() bills its tokens under the static placements, as the
    reference's does, and serves under the adaptive controller too
    (``tests/test_torch_placement.py`` holds both to the reference)."""
    out = serve("llama3.2-3b", num_requests=5, slots=2, max_new_tokens=4,
                device="cpu")
    assert out["completed"] == 5 and out["rejected"] == 0
    assert out["decode_tokens"] == 5 * 3  # the first token rides on prefill
    assert all(len(o) == 4 for o in out["outputs"].values())
    rates = PR.static_placements("llama3.2-3b", {"data": 16, "model": 16})
    prefill = out["total_tokens"] - out["decode_tokens"]
    assert out["energy_ws"] > 0.0
    assert out["energy_ws"] == pytest.approx(
        prefill * rates["prefill"].energy_per_token_ws
        + out["decode_tokens"] * rates["decode"].energy_per_token_ws,
        rel=1e-12)
    assert set(out["placements"]) == {"prefill", "decode"}
    assert all(d == "data16xmodel16" for _, d in out["served_by"].values())
    adaptive = serve("llama3.2-3b", num_requests=5, slots=2,
                     max_new_tokens=4, adaptive=True, interval_steps=4,
                     cache_path=str(tmp_path / "cache.jsonl"), device="cpu")
    assert adaptive["outputs"] == out["outputs"]
    assert adaptive["new_measurements"] > 0


@pytest.mark.parametrize("scheduler", ["stream", "wave"])
def test_serve_rwkv_on_cpu_completes_every_request(scheduler):
    out = serve(RWKV, num_requests=5, slots=2, max_new_tokens=4,
                scheduler=scheduler, device="cpu")
    assert out["completed"] == 5 and out["rejected"] == 0
    assert out["decode_tokens"] == 5 * 3
    assert all(len(o) == 4 for o in out["outputs"].values())


@pytest.mark.parametrize("scheduler", ["stream", "wave"])
def test_serve_hybrid_on_cpu_completes_every_request(scheduler):
    out = serve(HYBRID, num_requests=5, slots=2, max_new_tokens=4,
                scheduler=scheduler, device="cpu")
    assert out["completed"] == 5 and out["rejected"] == 0
    assert out["decode_tokens"] == 5 * 3
    assert all(len(o) == 4 for o in out["outputs"].values())


@pytest.mark.parametrize("scheduler", ["stream", "wave"])
def test_serve_moe_on_cpu_completes_every_request(scheduler):
    out = serve(MOE, num_requests=5, slots=2, max_new_tokens=4,
                scheduler=scheduler, device="cpu")
    assert out["completed"] == 5 and out["rejected"] == 0
    assert out["decode_tokens"] == 5 * 3
    assert all(len(o) == 4 for o in out["outputs"].values())


@pytest.mark.parametrize("scheduler", ["stream", "wave"])
@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_serve_encdec_and_vlm_on_cpu_complete_every_request(arch, scheduler):
    out = serve(arch, num_requests=5, slots=2, max_new_tokens=4,
                scheduler=scheduler, device="cpu")
    assert out["completed"] == 5 and out["rejected"] == 0
    assert out["decode_tokens"] == 5 * 3
    assert all(len(o) == 4 for o in out["outputs"].values())
