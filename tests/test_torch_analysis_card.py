"""The trace-based analysis on the card. These need a CUDA card and skip
elsewhere; the file imports no JAX, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_analysis_card.py

Every kernel family's launches at the main paths' shapes
(``kernel_lint.CARD_CASES``) lint with no error; each library's
``<prefix>_plan`` equals the Python plan of the same launch, with at
least one block an SM, local memory reported; the engine's ``_step``
keeps every cache and recurrent state leaf in its storage on the card;
and a decode step
synchronises with the host as often as the walker's ``host-sync`` count
says on fake CUDA tensors of the same config (none).
"""
import warnings

import pytest
import torch

from repro_torch.analysis import graph_walk
from repro_torch.analysis.kernel_lint import (CARD_CASES, capture_family,
                                              lint_captured, lint_on_card)
from repro_torch.analysis.offload_lint import (_decode_shapes, fake_model,
                                               lint_graph_hazards)

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs a CUDA card"),
]


@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_launches_lint_clean_and_plans_match_the_library(case):
    """No error finding: the library launches what the Python plan says,
    at least one block an SM. A kernel that spills (``register-spill``, a
    warning: B3's scalar f32 dQ kernel at head dim 128 keeps 16 bytes a
    thread in local memory) is reported, not refused."""
    calls = capture_family(CARD_CASES[case])
    assert calls
    for call in calls:
        found = lint_captured(call, site=case)
        card, attrs = lint_on_card(call, site=case)
        assert [f for f in found + card
                if f.rule not in ("ref-alias", "register-spill")] == [], \
            (call.kernel_name, attrs)
        assert attrs["plan"] == [list(call.grid), list(call.block),
                                 call.smem]
        assert attrs["blocks_per_sm"] >= 1
        assert ("register-spill" in [f.rule for f in card]) \
            == (attrs["local_bytes"] > 0)


def _engine_state(arch):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serving import ServingEngine

    cfg = reduced(get_config(arch))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    model = T.init_params(cfg, gen, device="cuda")
    engine = ServingEngine(cfg, model, slots=2, max_len=64, device="cuda")
    state = T.init_decode_state(cfg, 2, 64, device="cuda")
    tokens = torch.ones((2,), dtype=torch.int32, device="cuda")
    return cfg, model, engine, state, tokens


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-1.6b", "zamba2-7b"])
def test_step_keeps_state_storages_on_the_card(arch):
    """Every state leaf but the (B,) position vector comes back from
    ``_step`` in its own storage (``decode_step`` replaces ``pos``)."""
    from repro_torch._tree import flatten

    _, model, engine, state, tokens = _engine_state(arch)
    before = {p: t.data_ptr() for p, t in flatten(state)}
    _, out = engine._step(model, state, tokens)
    torch.cuda.synchronize()
    after = {p: t.data_ptr() for p, t in flatten(out)}
    assert [p for p in before if after[p] != before[p]] == [("pos",)]


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-1.6b", "zamba2-7b"])
def test_host_syncs_match_the_walker(arch):
    """The card's synchronising calls in one ``_step`` (CUDA's sync debug
    mode, warnings captured) equal the walker's ``host-sync`` count on fake
    CUDA tensors of the same config."""
    from repro_torch.models import transformer as T

    cfg, model, engine, state, tokens = _engine_state(arch)
    engine._step(model, state, tokens)  # the first call builds the kernels
    torch.cuda.synchronize()
    mode = graph_walk.fake_mode()
    fake = fake_model(cfg, mode)
    fstate, ftokens = _decode_shapes(cfg, 2, 64, mode)
    report = graph_walk.trace_and_walk(
        lambda s, t: T.decode_step(cfg, fake, s, t), fstate, ftokens)
    walked = [f for f in lint_graph_hazards(report, site=arch)
              if f.rule == "host-sync"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            engine._step(model, state, tokens)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the first use of the mode also warns that it is a prototype
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == len(walked)
