"""The race lint in the port (``repro_torch.analysis.concurrency``),
held to the JAX package's on every synthetic fixture of
``tests/test_concurrency.py``, and the port's own runtime linting clean.

The fixtures are read out of that file (every string literal in it that
holds a class and imports ``threading``, and RACY with the single-writer
marker, as its tests use it), so a fixture added there is held here too.
Findings, stable ids, ``to_json`` and the shared-state map must be the
same in both packages. The one place the port's copy differs (a bare-name
call under a lock, in a method with call-graph edges, where the
reference's ``lock_order_graph`` raises IndexError) has its own fixture.
"""
import ast
import inspect
from pathlib import Path

import pytest

from repro.analysis import concurrency as ref_lint
from repro_torch.analysis import concurrency as port_lint

ROOT = Path(__file__).resolve().parent.parent


def _fixtures() -> dict[str, str]:
    tree = ast.parse((ROOT / "tests" / "test_concurrency.py").read_text())
    where = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.parent_name = getattr(node, "name", None) or getattr(
                node, "parent_name", "module")
    found = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "import threading" in node.value and "class " in \
                node.value:
            name = getattr(node, "parent_name", "module")
            where[name] = where.get(name, 0) + 1
            found[f"{name}[{where[name] - 1}]"] = node.value
    racy = next(v for v in found.values() if "class Racy:" in v)
    found["RACY single-writer"] = racy.replace(
        "class Racy:", 'class Racy:\n    "Thread-safety: single-writer."')
    return found


FIXTURES = _fixtures()

# a bare-name call (str) under a lock, in a method with call-graph edges
BARE_NAME_UNDER_LOCK = """
import threading

class Loader:
    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None

    def _open(self):
        return object()

    def load(self):
        with self._lock:
            if self._lib is None:
                self._lib = self._open()
            return str(self._lib)
"""


def _report(lint, src):
    rep = lint.lint_scan(lint.scan_source(src, module="fix"))
    return {"fids": [f.fid for f in rep.findings],
            "findings": [f.to_json() for f in rep.findings],
            "shared": [s.to_json() for s in rep.shared],
            "entries": rep.entries, "disciplines": rep.disciplines}


def test_fixtures_read_from_the_reference_tests():
    # RACY, its marked twin, and the 17 others of tests/test_concurrency.py
    assert len(FIXTURES) >= 15, sorted(FIXTURES)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_lints_as_in_the_reference(name):
    src = FIXTURES[name]
    assert _report(port_lint, src) == _report(ref_lint, src)


def test_fixtures_cover_every_finding_kind():
    seen = set()
    for src in FIXTURES.values():
        seen |= {f["rule"] for f in _report(port_lint, src)["findings"]}
    assert seen == {"shared-write", "mixed-guard", "lock-cycle",
                    "lock-blocking", "global-write"}


def test_bare_name_call_under_a_lock_lints_in_the_port():
    """Reference caveat: the reference's ``lock_order_graph`` takes
    ``disp.rsplit(".", 1)[1]`` of a call made under a lock, which has no
    second part for ``str(...)``. The port's copy takes the last part."""
    scan = ref_lint.scan_source(BARE_NAME_UNDER_LOCK, module="fix")
    with pytest.raises(IndexError):
        ref_lint.lint_scan(scan)
    rep = _report(port_lint, BARE_NAME_UNDER_LOCK)
    assert rep["fids"] == []
    assert rep["disciplines"] == {"fix.Loader": "lock(_lock)"}


def test_blocking_bare_name_call_under_a_lock_is_flagged_in_the_port():
    src = BARE_NAME_UNDER_LOCK.replace(
        "        return object()",
        "        import time\n        time.sleep(0.1)\n        return object()")
    assert _report(port_lint, src)["fids"] == [
        "lock-blocking:fix.Loader.load/_open"]


def test_port_runtime_lints_clean():
    """The port's gate: zero findings over src/repro_torch with an empty
    baseline, the fleet executor's, the data prefetch's and the
    checkpointer's threads among the roots."""
    rep = port_lint.lint_runtime()
    assert rep.findings == [], [f.fid for f in rep.findings]
    for entry in ("runtime.executor.FleetExecutor._step_engine",
                  "data.pipeline.PrefetchIterator._fill",
                  "checkpoint.checkpointer.Checkpointer.save.<locals>._write",
                  "telemetry.sampler.TraceRecorder._loop",
                  "core.evaluator.ThreadedExecutor.run"):
        assert f"repro_torch.{entry}" in rep.entries
    assert rep.disciplines["repro_torch.runtime.serving.ServingEngine"] \
        .count("single-writer") == 1


def test_kernel_library_is_lock_guarded_not_single_writer():
    """KernelLibrary's two findings are fixed, not marked: ``_lib`` is read
    and written under ``_lock`` only, and nvcc runs outside it."""
    from repro_torch.kernels import _build

    rep = port_lint.lint_runtime()
    assert rep.disciplines["repro_torch.kernels._build.KernelLibrary"] == \
        "lock(_lock)"
    assert port_lint.SINGLE_WRITER_MARKER not in inspect.getsource(
        _build.KernelLibrary)
    # the pre-fix load(), linted alone, gives the two findings back
    old = inspect.getsource(_build).replace(
        inspect.getsource(_build.KernelLibrary.load), '''    def load(self):
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                self._lib = ctypes.CDLL(str(self.build()))
        return self._lib
''')
    assert _report(port_lint, old)["fids"] == [
        "mixed-guard:fix.KernelLibrary._lib",
        "lock-blocking:fix.KernelLibrary.load/build"]


def test_lint_runtime_defaults_to_the_port():
    rep = port_lint.lint_runtime()
    assert all(r.startswith("repro_torch.") for r in rep.reachable)
    assert [e for e, _ in port_lint.DEFAULT_ENTRY_POINTS] == \
        [e for e, _ in ref_lint.DEFAULT_ENTRY_POINTS]
