"""HLO post-SPMD analysis: collective wire bytes + remat-duplication stats.

A copy of the JAX package's ``core/hlo_analysis.py`` (pure Python: ``re``,
``warnings`` and ``dataclasses``), held to it bit for bit; beside it,
``issued_collective_stats`` bills collectives recorded as a run issues
them by the same conventions (``wire_bytes``), which is how the port's dry
run, having no compiler and so no HLO, reads its collectives.

``collective_stats`` parses ``compiled.as_text()`` (optimized HLO of the
per-device SPMD program) and estimates bytes-on-wire per device for every
collective op, using ring-algorithm conventions:

    all-reduce        2·S·(n-1)/n      (S = result bytes)
    all-gather          S·(n-1)/n
    reduce-scatter      S·(n-1)        (result is the scattered shard)
    all-to-all          S·(n-1)/n
    collective-permute  S

Group size n is parsed from replica_groups (both {{...}} and iota
[g,n]<=[...] forms); ops inside while-loop bodies are multiplied by the
loop's known trip count when derivable from the HLO, else reported once
(the dry-run's delta-method probes avoid relying on that).
"""
from __future__ import annotations

import re
import warnings
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s64": 8, "u64": 8,
    "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

_OP_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\S+))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
# Any dtype-grammar token (f*/bf*/s*/u*/c*/pred) followed by a dims list —
# unknown dtypes resolve through _dtype_bytes (bit-width fallback + warning)
# instead of silently dropping or KeyError'ing on new HLO dtypes.
_SHAPE_RE = re.compile(r"\b((?:bf|f|s|u|c)\d\w*|pred)\[([0-9,]*)\]")
_GROUPS_BRACE_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")

# while-loop structure: `... while(...), condition=%cond, body=%body` plus
# computation headers `%name (params) -> result {` / `ENTRY %main ... {`
_WHILE_RE = re.compile(
    r"\bwhile\(.*?condition=%?([\w.\-]+).*?body=%?([\w.\-]+)"
    r"|\bwhile\(.*?body=%?([\w.\-]+).*?condition=%?([\w.\-]+)")
_COMP_HEADER_RE = re.compile(
    r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->\s*.*\{\s*$")
_CONST_INT_RE = re.compile(r"\bconstant\((\d+)\)")
_COMPARE_LT_RE = re.compile(r"\bcompare\(.*direction=LT")

_warned_dtypes: set[str] = set()


def _dtype_bytes(dt: str) -> float:
    """Bytes per element; unknown dtypes fall back to their bit-width
    (digits in the name) with a one-time warning instead of a KeyError."""
    size = _DTYPE_BYTES.get(dt)
    if size is not None:
        return size
    m = re.match(r"[a-z]+(\d+)", dt)
    fallback = int(m.group(1)) / 8.0 if m else 4.0
    if dt not in _warned_dtypes:
        _warned_dtypes.add(dt)
        warnings.warn(
            "hlo_analysis: unknown dtype %r — assuming %g bytes/element"
            % (dt, fallback), stacklevel=3)
    return fallback


@dataclass
class CollectiveStats:
    wire_bytes: float = 0.0  # per device
    by_kind: dict = field(default_factory=dict)
    count: int = 0

    def add(self, kind: str, bytes_: float, count: int = 1):
        self.wire_bytes += bytes_
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + bytes_
        self.count += count


def _shape_bytes(text: str) -> float:
    total = 0.0
    for dt, dims in _SHAPE_RE.findall(text):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _dtype_bytes(dt)
    return total


def _line_computations(lines: list[str]) -> list:
    """Per-line computation name (None for lines outside any computation)."""
    comp_of: list = []
    current = None
    for line in lines:
        if current is None:
            m = _COMP_HEADER_RE.match(line)
            current = m.group(1) if m else None
            comp_of.append(current)
        else:
            comp_of.append(current)
            if line.strip().startswith("}"):
                current = None
    return comp_of


def _computation_multipliers(lines: list[str], comp_of: list) -> dict:
    """Trip-count multiplier per computation name.

    A while op maps its body computation to the loop's trip count when the
    condition computation has the canonical counted-loop form (a single
    integer ``constant(K)`` plus a ``compare ... direction=LT``); otherwise
    the body counts once. Nested whiles multiply through their parents.
    """
    comp_lines: dict = {}
    for line, comp in zip(lines, comp_of):
        if comp is not None:
            comp_lines.setdefault(comp, []).append(line)
    parents: dict = {}  # body comp -> (enclosing comp, cond comp)
    for line, comp in zip(lines, comp_of):
        m = _WHILE_RE.search(line)
        if m:
            cond = m.group(1) or m.group(4)
            body = m.group(2) or m.group(3)
            parents.setdefault(body, (comp, cond))

    def trips_of(cond) -> int:
        text = "\n".join(comp_lines.get(cond, ()))
        if not _COMPARE_LT_RE.search(text):
            return 1
        consts = set(_CONST_INT_RE.findall(text))
        return int(consts.pop()) if len(consts) == 1 else 1

    mults: dict = {}

    def mult_of(comp, seen=()):
        if comp not in parents or comp in seen:
            return 1
        if comp not in mults:
            parent, cond = parents[comp]
            mults[comp] = trips_of(cond) * mult_of(parent, seen + (comp,))
        return mults[comp]

    for body in parents:
        mult_of(body)
    return mults


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_BRACE_RE.search(line)
    if m:
        return max(len([x for x in m.group(1).split(",") if x.strip() != ""]), 1)
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return max(int(m.group(2)), 1)
    return default


def collective_stats(hlo_text: str, default_group: int = 1) -> CollectiveStats:
    stats = CollectiveStats()
    lines = hlo_text.splitlines()
    comp_of = _line_computations(lines)
    mults = _computation_multipliers(lines, comp_of)
    for line, comp in zip(lines, comp_of):
        m = _OP_RE.search(line)
        if not m:
            continue
        trip_mult = mults.get(comp, 1)
        kind = m.group(3)
        shape_text = m.group(1) or m.group(2) or ""
        size = _shape_bytes(shape_text)
        if size == 0:
            continue
        n = _group_size(line, default_group)
        if n <= 1:
            continue
        if kind == "all-reduce":
            wire = 2.0 * size * (n - 1) / n
        elif kind == "all-gather":
            wire = size * (n - 1) / n
        elif kind == "reduce-scatter":
            wire = size * (n - 1)
        elif kind == "all-to-all":
            wire = size * (n - 1) / n
        else:  # collective-permute
            wire = size
        stats.add(kind, wire * trip_mult, count=trip_mult)
    return stats


_FUSION_RE = re.compile(r"\bfusion\b")


def remat_stats(hlo_text: str) -> dict:
    """Rough duplicate-op census — flags remat-inserted recompute."""
    op_counts: dict[str, int] = {}
    for line in hlo_text.splitlines():
        m = re.search(r"=\s*\S+\s+(dot|convolution)\(", line)
        if m:
            sig_m = _SHAPE_RE.findall(line)
            sig = (m.group(1), tuple(sig_m[:3]))
            op_counts[str(sig)] = op_counts.get(str(sig), 0) + 1
    dupes = {k: v for k, v in op_counts.items() if v > 1}
    return {"dot_signatures": len(op_counts),
            "duplicated_signatures": len(dupes),
            "max_duplication": max(dupes.values(), default=1)}


def wire_bytes(kind: str, size: float, n: int) -> float:
    """Bytes on the wire per device of one collective of ``kind`` whose
    result is ``size`` bytes over a group of ``n`` devices, by the ring
    conventions above (the module's docstring)."""
    if kind == "all-reduce":
        return 2.0 * size * (n - 1) / n
    if kind == "all-gather":
        return size * (n - 1) / n
    if kind == "reduce-scatter":
        return size * (n - 1)
    if kind == "all-to-all":
        return size * (n - 1) / n
    if kind == "collective-permute":
        return size
    raise ValueError(f"not a collective kind: {kind!r} (one of "
                     f"{_COLLECTIVES})")


def issued_collective_stats(issued) -> CollectiveStats:
    """``CollectiveStats`` of the collectives a run issued, each ``(kind,
    result bytes, group size)``, billed as ``collective_stats`` bills an
    HLO line of the same op: a group of one device, or an empty result,
    moves nothing and is not counted. The port has no HLO text; its dry run
    (``launch/dryrun.py``) records the collectives as its step issues
    them."""
    stats = CollectiveStats()
    for kind, size, n in issued:
        if size == 0 or n <= 1:
            continue
        stats.add(kind, wire_bytes(kind, float(size), int(n)))
    return stats
