"""The lint finding type, shared by the port's lints.

Counterpart of the head of the JAX package's ``analysis/offload_lint.py``:
``Finding`` (one finding with a stable ``fid``), ``SEVERITIES`` and
``_sorted``, which the race lint (``analysis/concurrency.py``) reports
with. The rest of that module lints traced decode programs (host syncs,
un-donated state, f32 promotions, retrace hazards, dynamic loops) and
comes to the port with the trace-based analysis, over the port's own
graphs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

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
