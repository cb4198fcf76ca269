"""Serving-hot-path lint over traced decode programs, and its CLI gate.

Counterpart of the JAX package's ``analysis/offload_lint.py`` and of its
CLI, ``tools/offload_lint.py``. The programs are the port's own, traced on
fake tensors on the card (:mod:`repro_torch.analysis.graph_walk`); nothing
runs on a device.

Rules (stable IDs are ``<rule>:<site>``; the CLI baseline stores IDs):

* ``host-sync`` (error) — a node that waits for the card inside the decode
  step (``.item()``, ``nonzero``, a copy of a tensor on the card to the
  CPU). Each one forces a device→host round trip per decoded token,
  serializing the hot loop.
* ``undonated-state`` (error) — a large state buffer that comes back from
  the step in a storage other than its input's. Eager PyTorch has no XLA
  donation: its counterpart is the in-place update of the decode state,
  without which the KV/recurrent state doubles its memory and pays a copy
  per token.
* ``f32-promote`` (warn) — a bf16/f16 → float32 conversion on the decode
  path whose result is state-sized (≥ half the largest decode-state leaf).
  Small f32 islands (softmax accumulators) are deliberate and stay under
  the threshold.
* ``retrace-hazard`` (warn) — tracing the step at two batch sizes yields
  different op multisets, i.e. Python-level control flow depends on shapes
  and every new shape runs *a different program*. The port's layer loops
  unroll, so graphs of two shapes are compared by their multisets, not
  node by node.
* ``dynamic-loop`` (info) — a ``while_loop`` with no static trip count
  inside the step; fine for argmax-style search, but it hides cost from
  the static screen, so it is surfaced.

The engine's argmax fetch (``runtime/serving.py`` ``stream_step`` and
``wave_step``, ``.cpu()`` of the greedy tokens) lies outside its ``_step``,
as the JAX package's host fetch lies outside its jitted ``_step``: the lint
does not see it in either package.

``python -m repro_torch.analysis.offload_lint`` runs
:mod:`repro_torch.analysis.kernel_lint` over the four kernel families and
this lint over the dense/ssm/hybrid decode steps (including the real
``ServingEngine._step``'s in-place state), then gates against a checked-in
baseline (``offload_lint_baseline.json`` beside this module):

* findings whose stable ID is **not** in the baseline are *new* → exit 1;
* baselined findings are reported but tolerated (accepted debt);
* baseline entries that no longer fire are reported as fixed (prune them
  with ``--update-baseline``).

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.offload_lint
    PYTHONPATH=src python -m repro_torch.analysis.offload_lint --json out.json
    PYTHONPATH=src python -m repro_torch.analysis.offload_lint \\
        --update-baseline
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from collections import Counter
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

SEVERITIES = ("error", "warn", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding. ``fid`` is stable across runs for baselining."""

    rule: str
    severity: str
    site: str
    message: str
    value: Optional[float] = None

    @property
    def fid(self) -> str:
        return "%s:%s" % (self.rule, self.site)

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["fid"] = self.fid
        return d


def _sorted(findings: List[Finding]) -> List[Finding]:
    order = {s: i for i, s in enumerate(SEVERITIES)}
    return sorted(findings, key=lambda f: (order.get(f.severity, 9), f.fid))


# ---------------------------------------------------------------------------
# Graph-level hazards
# ---------------------------------------------------------------------------


def lint_graph_hazards(report, *, site: str,
                       state_leaf_bytes: float = 0.0) -> List[Finding]:
    """Lint a walked region (``graph_walk.RegionReport``) for host syncs,
    f32 promotions and dynamic loops.

    ``state_leaf_bytes`` scales the f32-promotion threshold: conversions
    producing ≥ half the largest decode-state leaf are flagged, so the
    rule tracks the model size instead of a fixed byte count.
    """
    findings: List[Finding] = []
    for cb in report.callbacks:
        findings.append(Finding(
            "host-sync", "error", "%s/%s" % (site, cb),
            "host sync on the decode path forces a device sync per step"))
    for loop in report.dynamic_loops:
        findings.append(Finding(
            "dynamic-loop", "info", "%s/%s" % (site, loop),
            "while-loop trip count is not static; cost invisible to screen"))
    threshold = 0.5 * state_leaf_bytes
    if threshold > 0:
        for path, src, dst, out_bytes in report.conversions:
            if dst == "float32" and src in ("bfloat16", "float16") \
                    and out_bytes >= threshold:
                findings.append(Finding(
                    "f32-promote", "warn", "%s/%s" % (site, path),
                    "state-sized %s->float32 promotion (%d bytes) on the "
                    "decode path" % (src, out_bytes), value=float(out_bytes)))
    return _sorted(findings)


# ---------------------------------------------------------------------------
# Donation lint (the state updated in place)
# ---------------------------------------------------------------------------

_SHORT_DTYPES = {
    "bfloat16": "bf16", "float16": "f16", "float32": "f32", "float64": "f64",
    "int8": "i8", "int16": "i16", "int32": "i32", "int64": "i64",
    "uint8": "ui8", "bool": "i1",
}


def _signature(t) -> str:
    """A tensor's type as the reference's sites spell it
    (``2x64x4x16xbf16``)."""
    dtype = str(t.dtype).replace("torch.", "")
    return "x".join([str(int(d)) for d in t.shape]
                    + [_SHORT_DTYPES.get(dtype, dtype)])


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _storage_key(t) -> int:
    return t.untyped_storage()._cdata


def lint_donation(step: Callable[..., Any], args: Sequence[Any], *,
                  site: str, min_bytes: int = 1 << 16) -> List[Finding]:
    """Flag large round-tripping buffers the step does not update in place.

    Runs ``step(*args)`` once on fake tensors (``args``' real tensors and
    ``TensorSpec``s become fake ones; the kernels record their launches
    and run none) and compares storages: an input tensor ≥ ``min_bytes``
    whose shape and dtype also appear among the outputs (a round-tripping
    buffer) but whose storage no output shares is an un-donated state
    buffer: the step allocates and writes a second one of its size a
    call.
    """
    import torch
    from torch._guards import detect_fake_mode
    from torch.utils import _pytree

    from repro_torch.analysis import graph_walk
    from repro_torch.kernels._build import capturing

    leaves, spec = _pytree.tree_flatten(list(args))
    leaves = graph_walk.fake_leaves(leaves)
    inputs = [x for x in leaves if isinstance(x, torch.Tensor)]
    with detect_fake_mode(inputs), graph_walk.cuda_bindings(), capturing(), \
            graph_walk.quiet_fake_pointers():
        out = step(*_pytree.tree_unflatten(leaves, spec))
        outs = [t for t in _pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        result_types = Counter((tuple(t.shape), t.dtype) for t in outs)
        out_keys = {_storage_key(t) for t in outs}
        findings: List[Finding] = []
        for idx, t in enumerate(inputs):
            nbytes = _nbytes(t)
            if nbytes >= min_bytes \
                    and result_types.get((tuple(t.shape), t.dtype), 0) \
                    and _storage_key(t) not in out_keys:
                findings.append(Finding(
                    "undonated-state", "error",
                    "%s/arg%d<%s>" % (site, idx, _signature(t)),
                    "buffer round-trips through the step (%d bytes) "
                    "without an in-place update; costs a copy + double "
                    "residency per token" % nbytes, value=float(nbytes)))
    return _sorted(findings)


# ---------------------------------------------------------------------------
# Retrace hazard (shape-dependent program structure)
# ---------------------------------------------------------------------------


def retrace_signature(fn: Callable[..., Any], args: Sequence[Any]) -> Counter:
    """Op-name multiset of the traced program (recursive)."""
    from repro_torch.analysis import graph_walk

    rep = graph_walk.trace_and_walk(fn, *args)
    return Counter(rep.primitive_counts)


def lint_retrace(fn: Callable[..., Any],
                 args_small: Sequence[Any], args_large: Sequence[Any], *,
                 site: str) -> List[Finding]:
    """Trace at two batch sizes; differing op multisets mean the Python
    built a *different program* per shape (retrace hazard)."""
    sig_a = retrace_signature(fn, args_small)
    sig_b = retrace_signature(fn, args_large)
    if sig_a == sig_b:
        return []
    delta = {k: sig_b[k] - sig_a[k]
             for k in set(sig_a) | set(sig_b) if sig_a[k] != sig_b[k]}
    return [Finding(
        "retrace-hazard", "warn", site,
        "program structure depends on batch size (primitive deltas: %s)"
        % (dict(sorted(delta.items())),))]


# ---------------------------------------------------------------------------
# Model-family entry points (what the CLI lints)
# ---------------------------------------------------------------------------

#: family -> reduced arch used to lint that decode path.
DECODE_FAMILIES: Dict[str, str] = {
    "dense": "llama3.2-3b",
    "ssm": "rwkv6-1.6b",
    "hybrid": "zamba2-7b",
}


def fake_model(cfg, mode):
    """``cfg``'s ``TransformerLM`` on fake tensors of ``mode`` on the card:
    every leaf of ``model_defs``, no weight drawn."""
    import torch

    from repro_torch._tree import tree_map
    from repro_torch.analysis import graph_walk
    from repro_torch.models import transformer as T

    with mode, graph_walk.cuda_bindings():
        tree = tree_map(lambda d: torch.empty(
            d.shape, dtype=d.dtype or T.DTYPES[cfg.dtype], device="cuda"),
            T.model_defs(cfg))
        return T.TransformerLM.from_stacked(cfg, tree)


def _decode_shapes(cfg, batch: int, cache_len: int, mode):
    """(state, tokens) of a decode step on fake tensors of ``mode`` on the
    card: the state ``init_decode_state`` makes, and (batch,) int32
    tokens."""
    import torch

    from repro_torch._tree import tree_map
    from repro_torch.models import transformer as T

    with mode:
        state = tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="cuda"),
            T.init_decode_state(cfg, batch, cache_len, device="cpu"))
        tokens = torch.zeros((batch,), dtype=torch.int32, device="cuda")
    return state, tokens


def _max_leaf_bytes(tree: Any) -> float:
    from repro_torch._tree import leaves

    return float(max(_nbytes(t) for t in leaves(tree)))


def lint_decode_family(family: str, *, batch: int = 2,
                       cache_len: int = 64) -> Tuple[List[Finding], Any]:
    """Lint one decode family's hot path end to end.

    Walks ``decode_step`` traced on fake CUDA tensors for hazards, runs the
    *actual* ``ServingEngine._step`` to check that the state comes back in
    its own storages, and compares traces at two batch sizes for retrace
    hazards. Returns (findings, region report) so callers can also inspect
    the static costs.
    """
    import torch

    from repro_torch.analysis import graph_walk
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serving import ServingEngine

    cfg = reduced(get_config(DECODE_FAMILIES[family]))
    site = "decode/%s" % family
    mode = graph_walk.fake_mode()
    model = fake_model(cfg, mode)
    state, tokens = _decode_shapes(cfg, batch, cache_len, mode)

    step = lambda s, t: T.decode_step(cfg, model, s, t)  # noqa: E731
    report = graph_walk.trace_and_walk(step, state, tokens)
    findings = lint_graph_hazards(
        report, site=site, state_leaf_bytes=_max_leaf_bytes(state))

    engine = ServingEngine(cfg, None, slots=batch, max_len=cache_len,
                           device="cuda" if torch.cuda.is_available()
                           else "cpu")
    # Threshold scales with the model: anything a quarter of the largest
    # decode-state leaf is state-sized, whatever the config size.
    min_bytes = max(4096, int(0.25 * _max_leaf_bytes(state)))
    state1, tokens1 = _decode_shapes(cfg, batch, cache_len, mode)
    findings += lint_donation(engine._step, (model, state1, tokens1),
                              site=site + "/serving_step",
                              min_bytes=min_bytes)

    state2, tokens2 = _decode_shapes(cfg, batch + 1, cache_len, mode)
    findings += lint_retrace(step, (state1, tokens1), (state2, tokens2),
                             site=site)
    return _sorted(findings), report


def lint_model_families(families: Sequence[str] = ("dense", "ssm", "hybrid"),
                        ) -> Tuple[List[Finding], Dict[str, Any]]:
    """Lint every decode family; returns merged findings + per-family
    reports."""
    findings: List[Finding] = []
    reports: Dict[str, Any] = {}
    for family in families:
        f, rep = lint_decode_family(family)
        findings += f
        reports[family] = rep
    return _sorted(findings), reports


# ---------------------------------------------------------------------------
# The CLI gate
# ---------------------------------------------------------------------------

DEFAULT_BASELINE = Path(__file__).resolve().parent \
    / "offload_lint_baseline.json"


def collect_findings(kernel_families=None, model_families=None):
    """Run both lint layers; returns (findings, stats-dict)."""
    from repro_torch.analysis.kernel_lint import (KERNEL_FAMILIES,
                                                  lint_kernel_families)

    kf, launch_counts = lint_kernel_families(
        kernel_families or tuple(KERNEL_FAMILIES))
    mf, reports = lint_model_families(
        model_families or ("dense", "ssm", "hybrid"))
    stats = {
        "launches": launch_counts,
        "decode_regions": {
            fam: {"flops": rep.flops, "hbm_bytes": rep.hbm_bytes,
                  "intensity": rep.intensity, "eqns": rep.eqn_count}
            for fam, rep in reports.items()},
    }
    return kf + mf, stats


def load_baseline(path: Path) -> set[str]:
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return set(data.get("accepted", []))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Offload-lint CLI: static analysis gate for kernels + "
                    "decode hot paths.")
    ap.add_argument("--json", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="accepted-findings file (default: %(default)s)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to exactly the current "
                         "findings and exit 0")
    args = ap.parse_args(argv)

    findings, stats = collect_findings()
    baseline_path = Path(args.baseline)
    accepted = load_baseline(baseline_path)

    fids = [f.fid for f in findings]
    new = [f for f in findings if f.fid not in accepted]
    fixed = sorted(accepted - set(fids))

    if args.update_baseline:
        baseline_path.write_text(json.dumps(
            {"version": 1, "accepted": sorted(set(fids))}, indent=2) + "\n")
        print("baseline updated: %d accepted finding(s) -> %s"
              % (len(set(fids)), baseline_path))
        return 0

    counts: dict[str, int] = {}
    for f in findings:
        counts[f.severity] = counts.get(f.severity, 0) + 1

    if args.json:
        Path(args.json).write_text(json.dumps({
            "findings": [f.to_json() for f in findings],
            "counts": counts,
            "new": [f.fid for f in new],
            "fixed_baseline_entries": fixed,
            "baseline": str(baseline_path),
            "stats": stats,
        }, indent=2) + "\n")

    new_fids = {n.fid for n in new}
    for f in findings:
        marker = "NEW " if f.fid in new_fids else ""
        print("%s%-5s %s — %s" % (marker, f.severity.upper(), f.fid,
                                  f.message))
    for fid in fixed:
        print("FIXED (prune from baseline): %s" % fid)
    print("offload-lint: %d finding(s) (%s), %d new, %d baselined, "
          "%d fixed baseline entr%s"
          % (len(findings),
             ", ".join("%d %s" % (n, s) for s, n in sorted(counts.items()))
             or "none",
             len(new), len(findings) - len(new), len(fixed),
             "y" if len(fixed) == 1 else "ies"))
    if new:
        print("offload-lint: FAIL — new findings above are not in the "
              "baseline (%s)" % baseline_path)
        return 1
    print("offload-lint: clean against baseline")
    return 0


if __name__ == "__main__":
    sys.exit(main())
