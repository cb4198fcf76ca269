"""The port's offload lint (``repro_torch.analysis.offload_lint``) and its
CLI gate on the CPU.

Each rule fires on a synthetic positive and stays quiet on the repo's own
decode paths (the gate's "clean" state), case for case as
``tests/test_analysis.py`` holds the JAX package's: the donation rule,
recast for eager PyTorch as the state updated in place, fires on ``s +
t`` and clears on ``s.add_(t)``; the f32 promotion rule's threshold; the
retrace rule on a Python loop over the batch; the dense, ssm and hybrid
decode families traced on fake CUDA tensors; the serving engine's
``_step`` updating its state in place. The CLI prints the reference CLI's
lines and returns its exit codes on the same findings, and the checked-in
baseline carries no debt.
"""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import graph_walk, offload_lint
from repro_torch.analysis.graph_walk import TensorSpec, trace_and_walk
from repro_torch.analysis.offload_lint import (
    Finding, _decode_shapes, fake_model, lint_decode_family, lint_donation,
    lint_graph_hazards, lint_retrace)
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.kernels._build import capturing

ROOT = Path(__file__).resolve().parent.parent


def test_donation_lint_fires_without_and_clears_with_inplace():
    state = TensorSpec((64, 64))  # 16 KiB round-trip
    tok = TensorSpec(())

    def bad(s, t):
        return s + t, torch.sum(s)

    def good(s, t):
        return s.add_(t), torch.sum(s)

    assert [f.rule for f in
            lint_donation(bad, (state, tok), site="t", min_bytes=4096)] \
        == ["undonated-state"]
    assert lint_donation(good, (state, tok), site="t", min_bytes=4096) == []
    (f,) = lint_donation(bad, (state, tok), site="t", min_bytes=4096)
    assert f.site == "t/arg0<64x64xf32>" and f.value == 64 * 64 * 4


def test_f32_promotion_rule_thresholds():
    def fn(x):
        big = x.to(torch.float32)  # state-sized promotion
        small = x[0].to(torch.float32)  # softmax-island-sized: tolerated
        return big.sum() + small.sum()

    rep = trace_and_walk(fn, TensorSpec((64, 64), torch.bfloat16))
    findings = lint_graph_hazards(rep, site="t",
                                  state_leaf_bytes=64 * 64 * 2)
    promos = [f for f in findings if f.rule == "f32-promote"]
    assert len(promos) == 1 and promos[0].value == 64 * 64 * 4


def test_retrace_lint_flags_shape_dependent_structure():
    def shape_dependent(x):
        out = x
        for _ in range(x.shape[0]):  # python loop over the batch dim
            out = out + 1.0
        return out

    small = (TensorSpec((2, 4)),)
    large = (TensorSpec((3, 4)),)
    (f,) = lint_retrace(shape_dependent, small, large, site="t")
    assert f.rule == "retrace-hazard" and "'add': 1" in f.message
    assert lint_retrace(lambda x: x + 1.0, small, large, site="t") == []


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid"])
def test_decode_families_lint_clean(family):
    """The repo's own decode hot paths carry no hazards (the gate's state):
    no host sync, the state updated in place, no retrace, no
    promotion."""
    findings, report = lint_decode_family(family)
    assert findings == []
    assert report.flops > 0 and report.hbm_bytes > 0
    assert report.by_kind["matmul"].count > 0


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-1.6b", "zamba2-7b"])
def test_serving_step_keeps_state_storages(arch):
    """The engine's ``_step`` writes every cache and recurrent leaf of the
    decode state into its own storage. The position vector ``pos``
    ((B,) int32) is the one leaf it replaces (``decode_step`` sets
    ``state["pos"] = pos + 1``), far under the rule's threshold."""
    from repro_torch._tree import flatten
    from repro_torch.runtime.serving import ServingEngine

    cfg = reduced(get_config(arch))
    mode = graph_walk.fake_mode()
    model = fake_model(cfg, mode)
    state, tokens = _decode_shapes(cfg, 2, 64, mode)
    before = {path: leaf.untyped_storage()._cdata
              for path, leaf in flatten(state)}
    engine = ServingEngine(cfg, None, slots=2, max_len=64, device="cpu")
    with mode, graph_walk.cuda_bindings(), graph_walk.quiet_fake_pointers(), \
            capturing():
        _, out = engine._step(model, state, tokens)
    after = {path: leaf.untyped_storage()._cdata
             for path, leaf in flatten(out)}
    assert after.keys() == before.keys()
    moved = [p for p in before if after[p] != before[p]]
    assert moved == [("pos",)]


# ---------------------------------------------------------------------------
# CLI + baseline gate
# ---------------------------------------------------------------------------


def _load_reference_cli():
    path = ROOT / "tools" / "offload_lint.py"
    spec = importlib.util.spec_from_file_location("offload_lint_cli", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_baseline_gate(tmp_path, monkeypatch, capsys):
    fake = [Finding("host-sync", "error", "decode/dense/x", "boom")]
    monkeypatch.setattr(offload_lint, "collect_findings",
                        lambda *a, **k: (fake, {}))
    cli = offload_lint.main
    baseline = tmp_path / "baseline.json"
    # no baseline -> the finding is new -> gate fails
    assert cli(["--baseline", str(baseline)]) == 1
    # accept it into the baseline -> gate passes, reported as baselined
    assert cli(["--baseline", str(baseline), "--update-baseline"]) == 0
    assert json.loads(baseline.read_text())["accepted"] \
        == ["host-sync:decode/dense/x"]
    assert cli(["--baseline", str(baseline)]) == 0
    # finding disappears -> reported fixed, still passes
    monkeypatch.setattr(offload_lint, "collect_findings",
                        lambda *a, **k: ([], {}))
    assert cli(["--baseline", str(baseline)]) == 0
    assert "FIXED" in capsys.readouterr().out


def test_cli_matches_the_reference_cli(tmp_path, monkeypatch, capsys):
    """The reference's ``tools/offload_lint.py`` and the port's CLI print
    the same lines and return the same exit codes on the same findings,
    step by step through the gate's life."""
    from repro.analysis.offload_lint import Finding as RefFinding

    ref = _load_reference_cli()
    baseline = tmp_path / "baseline.json"
    args = ["--baseline", str(baseline)]
    steps = [
        ([("host-sync", "error", "decode/dense/x", "boom"),
          ("dynamic-loop", "info", "decode/ssm/w", "loop")], args),
        ([("host-sync", "error", "decode/dense/x", "boom"),
          ("dynamic-loop", "info", "decode/ssm/w", "loop")],
         args + ["--update-baseline"]),
        ([("host-sync", "error", "decode/dense/x", "boom"),
          ("f32-promote", "warn", "decode/hybrid/c", "big")], args),
        ([], args),
    ]
    for found, argv in steps:
        outs, written = [], []
        for mod, kind in ((ref, RefFinding), (offload_lint, Finding)):
            monkeypatch.setattr(mod, "collect_findings",
                                lambda *a, f=found, k=kind, **kw: (
                                    [k(*x) for x in f], {}))
            outs.append((mod.main(list(argv)), capsys.readouterr().out))
            written.append(baseline.read_text() if baseline.exists()
                           else None)
        assert outs[0] == outs[1], outs
        assert written[0] == written[1]
    assert [rc for rc, _ in outs] == [0, 0]


def test_cli_clean_against_checked_in_baseline(capsys):
    """The real run: both lint layers over the repo exit 0 against the
    checked-in (empty) baseline, with each family's launches counted."""
    assert offload_lint.main([]) == 0
    out = capsys.readouterr().out
    assert "offload-lint: 0 finding(s) (none)" in out
    assert out.rstrip().endswith("offload-lint: clean against baseline")


def test_checked_in_baseline_is_empty():
    """The repo lints clean: the committed baseline carries no debt."""
    data = json.loads(offload_lint.DEFAULT_BASELINE.read_text())
    assert data == {"version": 1, "accepted": []}
