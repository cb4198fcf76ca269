"""AST-based race/deadlock lint over the runtime's own source.

Counterpart of the JAX package's ``analysis/concurrency.py``, copied as it
is but for two things: ``lint_runtime`` scans ``src/repro_torch`` by
default, and ``lock_order_graph`` and ``lint_lock_blocking`` take the last
dotted part of a call made under a lock (``disp.rsplit(".", 1)[-1]``), so
that a bare-name call such as ``str(...)`` under a lock, in a method with
call-graph edges, is linted where the reference raises ``IndexError``.

The offload lint reads programs before anything runs; this module applies
the same philosophy to the runtime that runs them. Before the fleet
executor (``runtime/executor.py``) turns threads loose on the serving
ledger, the lint proves the shared-state discipline is sound — statically,
the way arXiv 2110.11520 verifies multi-application offload correctness
before scaling it:

1. **shared-state map** — every ``self._x`` attribute and module global
   mutated by any method reachable from a *thread entry point* (a
   ``threading.Thread(target=...)`` body, a pool ``submit``/``map`` target,
   or an entry listed in :data:`DEFAULT_ENTRY_POINTS`), found by a
   call-graph walk with conservative receiver-type inference (constructor
   assignments, parameter/field annotations, subclass overrides).
2. **lock discipline** — per class, which attributes are only ever touched
   inside ``with self._lock`` (the guarded set), which are governed by a
   documented single-writer contract (``Thread-safety: single-writer`` in
   the class docstring), and which are bare.
3. **findings** with stable IDs (``<rule>:<site>``, the same baseline /
   NEW / FIXED machinery as ``tools/offload_lint.py``):

   * ``shared-write`` (error) — an attribute written outside any lock by a
     thread-reachable method while other methods also touch it, with no
     single-writer contract covering the class.
   * ``mixed-guard`` (error) — an attribute accessed both under and outside
     its class lock (a broken guard invariant; ``__init__`` is exempt —
     construction publishes the object).
   * ``lock-cycle`` (error) — a cycle in the cross-class lock-ordering
     graph (two threads acquiring the locks in opposite orders deadlock);
     length-1 cycles are a non-reentrant lock re-acquired.
   * ``lock-blocking`` (warn) — a blocking call (``sleep``/``join``/
     ``wait``/``open``/``flush``/subprocess) made, possibly transitively,
     while a lock is held: every other thread needing that lock stalls for
     the duration.

Happens-before edges the lint understands (so correct code lints clean):
writes in ``__init__``/``__post_init__`` (construction precedes
publication), writes *before* a ``.start()`` call in the same method
(thread creation), accesses *after* a ``.join()`` call in the same method
(thread termination), attributes holding known thread-safe types
(``threading.Lock``/``Event``/..., ``queue.Queue``), instances of
``threading.local`` subclasses, and classes carrying the single-writer
contract marker (the executor's lockstep barrier provides the
happens-before that makes the contract sound — see
``runtime/executor.py``).

The port's gate is the tier-1 test ``tests/test_torch_concurrency.py``:
``lint_runtime()`` over ``src/repro_torch`` with an empty baseline, and the
rules held to the JAX package's on its synthetic racy/deadlocky fixtures.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.offload_lint import Finding, _sorted

#: Docstring marker declaring a class single-writer: at most one thread
#: touches an instance at any moment; the coordinating code provides the
#: happens-before (e.g. the fleet executor's per-tick barrier).
SINGLE_WRITER_MARKER = "Thread-safety: single-writer"

#: Method calls that mutate their receiver in place.
MUTATORS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "pop",
    "popleft", "popitem", "remove", "discard", "clear", "add", "update",
    "setdefault", "sort", "reverse",
})

#: Constructor names whose instances are internally synchronized — writes
#: through them never need the owner's lock.
THREAD_SAFE_TYPES = frozenset({
    "Lock", "RLock", "Condition", "Event", "Semaphore", "BoundedSemaphore",
    "Barrier", "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
})

#: Call names that block the calling thread (checked under held locks).
#: ``os.write`` of one line to an O_APPEND fd is deliberately NOT here: it
#: is the sanctioned atomic-append primitive (core/cache_store.py).
BLOCKING_ATTR_CALLS = frozenset({"sleep", "join", "wait", "flush",
                                 "check_call", "check_output"})
BLOCKING_NAME_CALLS = frozenset({"open", "sleep"})

#: Entry points the walker cannot auto-detect (opaque callables handed to
#: pools, protocol-typed receivers). Each entry is (method qualname,
#: optional tuple of extra callees the call graph should link it to).
DEFAULT_ENTRY_POINTS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    # The recorder thread polls whatever sampler it was handed; PowerSampler
    # is a Protocol, so link both scanned implementations explicitly.
    ("TraceRecorder._loop",
     ("CounterSampler.read", "ModeledSampler.read")),
    # Pool fan-out of measure() callables: the functions are opaque at this
    # boundary; what they share is the EvalCache, reached via put/get.
    ("ThreadedExecutor.run", ("EvalCache.put", "EvalCache.get")),
    # Fleet executor workers step engines (EngineBinding.engine annotation
    # resolves this too; kept explicit so the certification does not hinge
    # on inference).
    ("FleetExecutor._step_engine", ("ServingEngine.stream_step",)),
)


# ---------------------------------------------------------------------------
# Scan model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Access:
    """One attribute access inside a method body."""

    attr: str
    kind: str  # "write" | "mutate" | "read"
    lineno: int
    locks: Tuple[str, ...]  # lock ids held at the access
    exempt: str = ""  # "", "init", "pre-start", "post-join", "safe-type"


@dataclasses.dataclass
class MethodInfo:
    name: str  # possibly nested: "save.<locals>._write"
    qualname: str  # Module.Class.name
    lineno: int = 0
    accesses: List[Access] = dataclasses.field(default_factory=list)
    # attribute-qualified self calls: method names invoked as self.m(...)
    self_calls: List[str] = dataclasses.field(default_factory=list)
    # resolved cross-class calls: qualnames of callee methods
    typed_calls: List[str] = dataclasses.field(default_factory=list)
    # (lock ids held, callee display, lineno) for blocking-call checks
    calls_under_lock: List[Tuple[Tuple[str, ...], str, int]] = \
        dataclasses.field(default_factory=list)
    # direct blocking calls: (display name, lineno, locks held)
    blocking: List[Tuple[str, int, Tuple[str, ...]]] = \
        dataclasses.field(default_factory=list)
    # blocking calls regardless of lock state: what makes this METHOD
    # blocking for callers that do hold a lock
    blocking_any: List[Tuple[str, int]] = \
        dataclasses.field(default_factory=list)
    # lock ids acquired directly in this body (with-statements)
    acquires: List[Tuple[str, Tuple[str, ...]]] = \
        dataclasses.field(default_factory=list)  # (lock, locks already held)
    # module globals mutated: (name, kind, lineno, locks, exempt)
    global_writes: List[Tuple[str, str, int, Tuple[str, ...], str]] = \
        dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ClassInfo:
    name: str
    module: str
    lineno: int = 0
    bases: Tuple[str, ...] = ()
    single_writer: bool = False
    thread_local: bool = False
    methods: Dict[str, MethodInfo] = dataclasses.field(default_factory=dict)
    lock_attrs: Set[str] = dataclasses.field(default_factory=set)
    safe_attrs: Set[str] = dataclasses.field(default_factory=set)
    # attr name -> scanned class name (from __init__ ctor / annotations)
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    # entry-point methods auto-detected inside this class
    thread_targets: Set[str] = dataclasses.field(default_factory=set)

    @property
    def qualname(self) -> str:
        return f"{self.module}.{self.name}"


@dataclasses.dataclass
class ScanResult:
    """Everything the AST pass extracted from one set of sources."""

    classes: Dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    # module -> lock-variable names defined at module scope
    module_locks: Dict[str, Set[str]] = dataclasses.field(default_factory=dict)
    # module -> names bound to threading.local instances at module scope
    module_thread_locals: Dict[str, Set[str]] = \
        dataclasses.field(default_factory=dict)
    files: List[str] = dataclasses.field(default_factory=list)

    def class_by_name(self, name: str) -> List[ClassInfo]:
        return [c for c in self.classes.values() if c.name == name]

    def subclasses_of(self, name: str) -> List[ClassInfo]:
        out = []
        for c in self.classes.values():
            if name in c.bases:
                out.append(c)
                out.extend(self.subclasses_of(c.name))
        return out


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _dotted(node: ast.expr) -> Optional[str]:
    """Best-effort dotted-name rendering (``a.b.c``) for receivers."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _ctor_class(node: ast.expr) -> Optional[str]:
    """Class name when ``node`` is ``Ctor(...)`` or ``x or Ctor(...)``."""
    if isinstance(node, ast.BoolOp):
        for v in node.values:
            got = _ctor_class(v)
            if got:
                return got
        return None
    if isinstance(node, ast.IfExp):
        return _ctor_class(node.body) or _ctor_class(node.orelse)
    if isinstance(node, ast.Call):
        name = _call_name(node)
        bare = name.lstrip("_")
        if bare and bare[0].isupper():  # _Ctx() is a ctor too
            return name
    return None


def _ann_class(ann: Optional[ast.expr]) -> Optional[str]:
    """Class name from an annotation node (handles Optional["X"]/str)."""
    if ann is None:
        return None
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.strip('"\'')
    if isinstance(ann, ast.Subscript):  # Optional[X], list[X] -> X is a guess
        return _ann_class(ann.slice)
    if isinstance(ann, ast.Attribute):
        return ann.attr
    return None


class _MethodVisitor(ast.NodeVisitor):
    """Walks one method body collecting accesses, calls and lock regions."""

    def __init__(self, scan: "_ClassScanner", info: MethodInfo,
                 is_init: bool) -> None:
        self.scan = scan
        self.info = info
        self.is_init = is_init
        self.locks: List[str] = []  # held-lock stack
        self.start_line: Optional[int] = None  # first Thread .start() call
        self.join_line: Optional[int] = None  # first .join() call
        # local variable name -> scanned class name
        self.var_types: Dict[str, str] = {}

    # -- happens-before bookkeeping ------------------------------------
    def _exempt(self, lineno: int) -> str:
        if self.is_init:
            return "init"
        if self.start_line is not None and lineno < self.start_line:
            return "pre-start"
        if self.join_line is not None and lineno > self.join_line:
            return "post-join"
        return ""

    # -- lock identification -------------------------------------------
    def _lock_id(self, node: ast.expr) -> Optional[str]:
        dotted = _dotted(node)
        if dotted is None:
            return None
        cls = self.scan.cls
        if dotted.startswith("self."):
            attr = dotted.split(".", 1)[1]
            if attr in cls.lock_attrs:
                return f"{cls.qualname}.{attr}"
            return None
        if dotted in self.scan.module_locks:
            return f"{cls.module}.{dotted}"
        return None

    # -- visitors ------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        held = []
        for item in node.items:
            lock = self._lock_id(item.context_expr)
            if lock is not None:
                self.info.acquires.append((lock, tuple(self.locks)))
                self.locks.append(lock)
                held.append(lock)
            else:
                # non-lock context managers (``with open(...)``) still carry
                # calls the blocking-under-lock rule must see
                self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for _ in held:
            self.locks.pop()

    visit_AsyncWith = visit_With

    def _record_attr(self, attr: str, kind: str, lineno: int) -> None:
        cls = self.scan.cls
        exempt = self._exempt(lineno)
        if attr in cls.lock_attrs or attr in cls.safe_attrs:
            exempt = exempt or "safe-type"
        self.info.accesses.append(Access(
            attr=attr, kind=kind, lineno=lineno,
            locks=tuple(self.locks), exempt=exempt))

    def _record_global(self, name: str, kind: str, lineno: int) -> None:
        self.info.global_writes.append(
            (name, kind, lineno, tuple(self.locks), self._exempt(lineno)))

    def _handle_store(self, target: ast.expr, lineno: int) -> None:
        # self.attr = ... / self.attr.field = ... / self.attr[k] = ...
        node = target
        kind = "write"
        while isinstance(node, (ast.Subscript, ast.Attribute)):
            parent = node.value
            if isinstance(node, ast.Attribute) \
                    and isinstance(parent, ast.Name) \
                    and parent.id == "self":
                self._record_attr(node.attr, kind, lineno)
                return
            node = parent
            kind = "mutate"  # store through a deeper path mutates the root
        if isinstance(node, ast.Name):
            mod = self.scan.cls.module
            if node.id in self.scan.module_globals \
                    and node.id not in self.scan.module_thread_locals \
                    and kind == "mutate":
                self._record_global(node.id, kind, lineno)
            elif node.id in self.info_globals():
                self._record_global(node.id, "write", lineno)

    def info_globals(self) -> Set[str]:
        return self.scan.declared_globals.get(self.info.name, set())

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._handle_store(t, node.lineno)
        self.visit(node.value)  # visit, not generic_visit: the value may
        # itself be the interesting call (``req = self.queue.popleft()``)
        # local type inference: x = Ctor(...) / self.attr = Ctor(...)
        ctor = _ctor_class(node.value)
        if ctor and self.scan.result_has_class(ctor):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.var_types[t.id] = ctor

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None or isinstance(node.target, (ast.Attribute,
                                                              ast.Subscript)):
            if node.value is not None:
                self._handle_store(node.target, node.lineno)
                self.visit(node.value)
        cls_name = _ann_class(node.annotation)
        if isinstance(node.target, ast.Name) and cls_name \
                and self.scan.result_has_class(cls_name):
            self.var_types[node.target.id] = cls_name

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._handle_store(node.target, node.lineno)
        self.visit(node.value)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.ctx, ast.Load) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self":
            self._record_attr(node.attr, "read", node.lineno)
        self.generic_visit(node)

    def _receiver_type(self, node: ast.expr) -> Optional[str]:
        """Scanned-class name of a call receiver, via chain inference."""
        dotted = _dotted(node)
        if dotted is None:
            return None
        parts = dotted.split(".")
        cur: Optional[str] = None
        if parts[0] == "self":
            cur = self.scan.cls.name
            parts = parts[1:]
        elif parts[0] in self.var_types:
            cur = self.var_types[parts[0]]
            parts = parts[1:]
        else:
            return None
        for attr in parts:
            infos = self.scan.result_class(cur)
            if infos is None:
                return None
            cur = infos.attr_types.get(attr)
            if cur is None:
                return None
        return cur

    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node)
        lineno = node.lineno
        if isinstance(node.func, ast.Attribute):
            # entry-point auto-detection: pool.submit(self.m,...), .map same
            if name in ("submit", "map"):
                for arg in node.args[:1]:
                    tgt = _dotted(arg)
                    if tgt and tgt.startswith("self."):
                        self.scan.cls.thread_targets.add(
                            tgt.split(".", 1)[1])
            receiver = node.func.value
            # mutator call on self.attr / on a module global
            if name in MUTATORS:
                dotted = _dotted(receiver)
                if dotted and dotted.startswith("self."):
                    root = dotted.split(".")[1]
                    self._record_attr(root, "mutate", lineno)
                elif dotted and dotted in self.scan.module_globals \
                        and dotted not in self.scan.module_thread_locals:
                    self._record_global(dotted, "mutate", lineno)
            # self-call / typed cross-class call resolution
            if isinstance(receiver, ast.Name) and receiver.id == "self":
                self.info.self_calls.append(name)
            else:
                rtype = self._receiver_type(receiver)
                if rtype is not None:
                    self.info.typed_calls.append(f"{rtype}.{name}")
            if self.locks:
                disp = _dotted(node.func) or name
                self.info.calls_under_lock.append(
                    (tuple(self.locks), disp, lineno))
            if name in BLOCKING_ATTR_CALLS:
                # Event.wait with a timeout still parks the thread; join and
                # sleep likewise. flush/subprocess block on I/O.
                disp = _dotted(node.func) or name
                self.info.blocking_any.append((disp, lineno))
                if self.locks:
                    self.info.blocking.append(
                        (disp, lineno, tuple(self.locks)))
        elif isinstance(node.func, ast.Name):
            if name in BLOCKING_NAME_CALLS:
                self.info.blocking_any.append((name, lineno))
                if self.locks:
                    self.info.blocking.append(
                        (name, lineno, tuple(self.locks)))
            if self.locks:
                self.info.calls_under_lock.append(
                    (tuple(self.locks), name, lineno))
        # threading.Thread(target=self._loop) / Thread(target=_local)
        if name == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    tgt = _dotted(kw.value)
                    if tgt and tgt.startswith("self."):
                        self.scan.cls.thread_targets.add(
                            tgt.split(".", 1)[1])
                    elif tgt:  # local closure defined in this method
                        self.scan.cls.thread_targets.add(
                            f"{self.info.name}.<locals>.{tgt}")
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # nested function: scanned as its own pseudo-method so writes from a
        # thread-target closure are attributed to the thread
        nested = self.scan.scan_method(
            node, name=f"{self.info.name}.<locals>.{node.name}")
        nested.lineno = node.lineno
        self.generic_visit(ast.Pass())  # do not descend twice

    visit_AsyncFunctionDef = visit_FunctionDef


class _ClassScanner:
    """Scans one class body into a :class:`ClassInfo`."""

    def __init__(self, result: ScanResult, module: str,
                 node: ast.ClassDef, module_locks: Set[str],
                 module_globals: Set[str], module_thread_locals: Set[str],
                 declared_globals: Dict[str, Set[str]]) -> None:
        self.result = result
        self.module = module
        self.node = node
        self.module_locks = module_locks
        self.module_globals = module_globals
        self.module_thread_locals = module_thread_locals
        self.declared_globals = declared_globals
        doc = ast.get_docstring(node) or ""
        self.cls = ClassInfo(
            name=node.name, module=module, lineno=node.lineno,
            bases=tuple(b for b in (_ann_class(x) for x in node.bases) if b),
            single_writer=SINGLE_WRITER_MARKER in doc,
            thread_local="local" in {(_ann_class(x) or "")
                                     for x in node.bases})

    def result_has_class(self, name: str) -> bool:
        return bool(self.result.class_by_name(name)) or name == self.cls.name

    def result_class(self, name: Optional[str]) -> Optional[ClassInfo]:
        if name is None:
            return None
        if name == self.cls.name:
            return self.cls
        found = self.result.class_by_name(name)
        return found[0] if found else None

    def scan(self) -> ClassInfo:
        # first pass: lock/safe/typed attributes from __init__-like bodies
        # and dataclass field annotations
        for stmt in self.node.body:
            if isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name):
                t = _ann_class(stmt.annotation)
                if t:
                    self.cls.attr_types[stmt.target.id] = t
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt.name in ("__init__", "__post_init__"):
                self._scan_init_types(stmt)
        # second pass: every method body
        for stmt in self.node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.scan_method(stmt, name=stmt.name)
        return self.cls

    def _scan_init_types(self, fn: ast.FunctionDef) -> None:
        # parameter annotations type self-assigned params:
        #   def __init__(self, sampler: PowerSampler): self.sampler = sampler
        param_types = {}
        args = fn.args
        for a in list(args.args) + list(args.kwonlyargs):
            t = _ann_class(a.annotation)
            if t:
                param_types[a.arg] = t
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    continue
                ctor = _ctor_class(node.value)
                if ctor in THREAD_SAFE_TYPES:
                    self.cls.safe_attrs.add(tgt.attr)
                    if ctor in ("Lock", "RLock"):
                        self.cls.lock_attrs.add(tgt.attr)
                    continue
                if ctor and self.result_has_class(ctor):
                    self.cls.attr_types.setdefault(tgt.attr, ctor)
                    continue
                if isinstance(node.value, ast.Name) \
                        and node.value.id in param_types:
                    self.cls.attr_types.setdefault(
                        tgt.attr, param_types[node.value.id])

    def scan_method(self, fn: ast.FunctionDef, *, name: str) -> MethodInfo:
        info = MethodInfo(name=name,
                          qualname=f"{self.cls.qualname}.{name}",
                          lineno=fn.lineno)
        self.declared_globals[name] = {
            g for stmt in ast.walk(fn) if isinstance(stmt, ast.Global)
            for g in stmt.names}
        visitor = _MethodVisitor(
            self, info, is_init=name in ("__init__", "__post_init__"))
        # happens-before markers are positional, so find them BEFORE the
        # main walk: a write on line 10 is pre-start-exempt when .start()
        # appears on line 14 (thread creation orders the publication)
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute):
                if sub.func.attr == "start" and visitor.start_line is None:
                    visitor.start_line = sub.lineno
                if sub.func.attr == "join" and visitor.join_line is None:
                    visitor.join_line = sub.lineno
        # param annotations seed local type inference
        for a in list(fn.args.args) + list(fn.args.kwonlyargs):
            t = _ann_class(a.annotation)
            if t and self.result_has_class(t):
                visitor.var_types[a.arg] = t
        for stmt in fn.body:
            visitor.visit(stmt)
        self.cls.methods[name] = info
        return info


def scan_source(src: str, *, module: str = "<memory>",
                result: Optional[ScanResult] = None) -> ScanResult:
    """Scan one module's source text into (or onto) a :class:`ScanResult`."""
    result = result or ScanResult()
    tree = ast.parse(src)
    module_locks: Set[str] = set()
    module_globals: Set[str] = set()
    module_thread_locals: Set[str] = set()
    # module scope: globals, module-level locks, threading.local instances
    local_classes = {n.name: n for n in tree.body
                     if isinstance(n, ast.ClassDef)}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
            module_globals.update(names)
            ctor = _ctor_class(node.value)
            if ctor in ("Lock", "RLock"):
                module_locks.update(names)
            if ctor == "local":
                module_thread_locals.update(names)
            if ctor in local_classes:
                cdef = local_classes[ctor]
                cbases = {_ann_class(b) for b in cdef.bases}
                if "local" in cbases:
                    module_thread_locals.update(names)
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            module_globals.add(node.target.id)
    result.module_locks.setdefault(module, set()).update(module_locks)
    result.module_thread_locals.setdefault(module, set()).update(
        module_thread_locals)
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            scanner = _ClassScanner(
                result, module, node, module_locks, module_globals,
                module_thread_locals, declared_globals={})
            info = scanner.scan()
            result.classes[info.qualname] = info
    return result


def scan_paths(paths: Iterable[str], *, root: Optional[str] = None
               ) -> ScanResult:
    """Scan ``.py`` files (or directories, recursively) into one result."""
    result = ScanResult()
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames) if f.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    for f in sorted(files):
        mod = os.path.relpath(f, root) if root else f
        mod = mod[:-3].replace(os.sep, ".")
        if mod.endswith(".__init__"):
            mod = mod[: -len(".__init__")]
        with open(f, "r", encoding="utf-8") as fh:
            scan_source(fh.read(), module=mod, result=result)
        result.files.append(f)
    return result


# ---------------------------------------------------------------------------
# Call graph + reachability
# ---------------------------------------------------------------------------


def _method_index(scan: ScanResult) -> Dict[str, List[str]]:
    """bare ``Class.method`` -> [qualified method ids] (incl. overrides)."""
    idx: Dict[str, List[str]] = {}
    for cls in scan.classes.values():
        for m in cls.methods.values():
            idx.setdefault(f"{cls.name}.{m.name}", []).append(m.qualname)
    return idx


def build_call_graph(scan: ScanResult,
                     extra_edges: Sequence[Tuple[str, Tuple[str, ...]]] = (),
                     ) -> Dict[str, Set[str]]:
    """Edges between fully-qualified method ids.

    ``self.m()`` resolves to the defining class *and* every scanned
    subclass override (dynamic dispatch); typed cross-class calls resolve
    through the inferred receiver types; ``extra_edges`` supplies what
    inference cannot see (opaque pool targets, Protocol receivers).
    """
    idx = _method_index(scan)
    graph: Dict[str, Set[str]] = {}
    for cls in scan.classes.values():
        subs = scan.subclasses_of(cls.name)
        for m in cls.methods.values():
            edges = graph.setdefault(m.qualname, set())
            for callee in m.self_calls:
                for c in [cls] + subs:
                    if callee in c.methods:
                        edges.add(c.methods[callee].qualname)
            for callee in m.typed_calls:
                for q in idx.get(callee, ()):
                    edges.add(q)
    for src_bare, callees in extra_edges:
        for src_q in idx.get(src_bare, [src_bare]):
            edges = graph.setdefault(src_q, set())
            for callee in callees:
                for q in idx.get(callee, [callee]):
                    edges.add(q)
    return graph


def thread_entry_points(scan: ScanResult,
                        extra: Sequence[Tuple[str, Tuple[str, ...]]] = (),
                        ) -> List[str]:
    """Qualified ids of methods that run on non-main threads."""
    idx = _method_index(scan)
    entries: List[str] = []
    for cls in scan.classes.values():
        for tgt in sorted(cls.thread_targets):
            if tgt in cls.methods:
                entries.append(cls.methods[tgt].qualname)
    for bare, _ in extra:
        entries.extend(idx.get(bare, ()))
    return sorted(set(entries))


def reachable_from(graph: Dict[str, Set[str]], roots: Iterable[str]
                   ) -> Set[str]:
    seen: Set[str] = set()
    stack = list(roots)
    while stack:
        cur = stack.pop()
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(graph.get(cur, ()))
    return seen


# ---------------------------------------------------------------------------
# Shared-state map
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SharedAttr:
    """One attribute the thread-reachable code mutates."""

    qualname: str  # Module.Class.attr
    writers: List[str]  # method qualnames writing from thread-reachable code
    discipline: str  # "lock" | "single-writer" | "confined" | "unguarded"
    lock: Optional[str] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _find_method(scan: ScanResult, qual: str
                 ) -> Optional[Tuple[ClassInfo, MethodInfo]]:
    for cls in scan.classes.values():
        for m in cls.methods.values():
            if m.qualname == qual:
                return cls, m
    return None


def shared_state_map(scan: ScanResult, reachable: Set[str]
                     ) -> List[SharedAttr]:
    """Every attribute / global mutated by thread-reachable methods, with
    its inferred discipline — the map the ARCHITECTURE table renders."""
    by_attr: Dict[str, Dict[str, object]] = {}
    for qual in sorted(reachable):
        found = _find_method(scan, qual)
        if found is None:
            continue
        cls, m = found
        for acc in m.accesses:
            if acc.kind not in ("write", "mutate") or acc.exempt:
                continue
            key = f"{cls.qualname}.{acc.attr}"
            rec = by_attr.setdefault(key, {"writers": set(), "locked": True,
                                           "locks": set(), "cls": cls})
            rec["writers"].add(qual)
            if acc.locks:
                rec["locks"].update(acc.locks)
            else:
                rec["locked"] = False
    out: List[SharedAttr] = []
    for key in sorted(by_attr):
        rec = by_attr[key]
        cls: ClassInfo = rec["cls"]  # type: ignore[assignment]
        attr = key.rsplit(".", 1)[1]
        if rec["locked"] and rec["locks"]:
            disc, lock = "lock", sorted(rec["locks"])[0]
        elif cls.single_writer:
            disc, lock = "single-writer", None
        elif _attr_confined(cls, attr):
            disc, lock = "confined", None
        else:
            disc, lock = "unguarded", None
        out.append(SharedAttr(qualname=key,
                              writers=sorted(rec["writers"]),
                              discipline=disc, lock=lock))
    return out


def _attr_confined(cls: ClassInfo, attr: str) -> bool:
    """True when every non-exempt access to ``attr`` lives in one method —
    thread-confined use (the method itself is the ownership boundary)."""
    touchers = {m.name for m in cls.methods.values()
                if any(a.attr == attr and not a.exempt for a in m.accesses)}
    return len(touchers) <= 1


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


def lint_shared_writes(scan: ScanResult, shared: List[SharedAttr]
                       ) -> List[Finding]:
    out = []
    for rec in shared:
        if rec.discipline != "unguarded":
            continue
        out.append(Finding(
            "shared-write", "error", rec.qualname,
            "written outside any lock from thread-reachable code (%s) "
            "while other methods also touch it; guard it, or document and "
            "uphold a single-writer contract"
            % ", ".join(w.rsplit(".", 1)[1] for w in rec.writers)))
    return _sorted(out)


def lint_global_writes(scan: ScanResult, reachable: Set[str]
                       ) -> List[Finding]:
    out = []
    for qual in sorted(reachable):
        found = _find_method(scan, qual)
        if found is None:
            continue
        cls, m = found
        for name, kind, lineno, locks, exempt in m.global_writes:
            if exempt or locks:
                continue
            out.append(Finding(
                "global-write", "error", f"{cls.module}.{name}",
                "module global mutated without a lock from thread-reachable "
                "code (%s)" % qual))
    return _sorted(out)


def lint_mixed_guard(scan: ScanResult) -> List[Finding]:
    """Attributes accessed both under and outside their class lock."""
    out = []
    for cls in scan.classes.values():
        if not cls.lock_attrs:
            continue
        guarded: Dict[str, Set[bool]] = {}
        written: Set[str] = set()
        for m in cls.methods.values():
            for acc in m.accesses:
                if acc.exempt or acc.attr in cls.lock_attrs \
                        or acc.attr in cls.safe_attrs:
                    continue
                guarded.setdefault(acc.attr, set()).add(bool(acc.locks))
                if acc.kind in ("write", "mutate"):
                    written.add(acc.attr)
        for attr, states in sorted(guarded.items()):
            # an attr never written after __init__ is immutable: mixed lock
            # states on pure reads are harmless (publication via ctor)
            if attr not in written:
                continue
            if states == {True, False} and not cls.single_writer:
                out.append(Finding(
                    "mixed-guard", "error", f"{cls.qualname}.{attr}",
                    "accessed both under and outside the class lock; the "
                    "guard invariant is broken"))
    return _sorted(out)


def _transitive_locks(scan: ScanResult, graph: Dict[str, Set[str]]
                      ) -> Dict[str, Set[str]]:
    """method qualname -> locks it may acquire (directly or via callees)."""
    direct: Dict[str, Set[str]] = {}
    for cls in scan.classes.values():
        for m in cls.methods.values():
            direct[m.qualname] = {lock for lock, _ in m.acquires}
    out = {q: set(s) for q, s in direct.items()}
    changed = True
    while changed:
        changed = False
        for q, edges in graph.items():
            acc = out.setdefault(q, set())
            for callee in edges:
                extra = out.get(callee, set()) - acc
                if extra:
                    acc.update(extra)
                    changed = True
    return out


def lock_order_graph(scan: ScanResult, graph: Dict[str, Set[str]]
                     ) -> Dict[str, Set[str]]:
    """lock -> locks that may be acquired while it is held."""
    trans = _transitive_locks(scan, graph)
    edges: Dict[str, Set[str]] = {}
    for cls in scan.classes.values():
        for m in cls.methods.values():
            # direct nesting: with A: with B:
            for lock, held in m.acquires:
                for h in held:
                    if h != lock:
                        edges.setdefault(h, set()).add(lock)
            # call under lock reaching an acquiring method
            for held, disp, _ in m.calls_under_lock:
                callees = {q for q in graph.get(m.qualname, ())
                           if q.rsplit(".", 1)[1] == disp.rsplit(".", 1)[-1]}
                for callee in callees:
                    for lock in trans.get(callee, ()):
                        for h in held:
                            edges.setdefault(h, set()).add(lock)
    return edges


def _find_cycles(edges: Dict[str, Set[str]]) -> List[Tuple[str, ...]]:
    cycles: Set[Tuple[str, ...]] = set()

    def dfs(start: str, cur: str, path: Tuple[str, ...]) -> None:
        for nxt in sorted(edges.get(cur, ())):
            if nxt == start:
                # canonicalize rotation for a stable ID
                cyc = path
                pivot = min(range(len(cyc)), key=lambda i: cyc[i])
                cycles.add(cyc[pivot:] + cyc[:pivot])
            elif nxt not in path and len(path) < 6:
                dfs(start, nxt, path + (nxt,))

    for lock in sorted(edges):
        if lock in edges.get(lock, ()):
            cycles.add((lock,))
        dfs(lock, lock, (lock,))
    return sorted(cycles)


def lint_lock_cycles(scan: ScanResult, graph: Dict[str, Set[str]]
                     ) -> List[Finding]:
    out = []
    for cyc in _find_cycles(lock_order_graph(scan, graph)):
        site = "->".join(cyc + (cyc[0],))
        msg = ("lock re-acquired while already held (non-reentrant "
               "self-deadlock)" if len(cyc) == 1 else
               "locks acquired in a cycle; two threads taking them in "
               "opposite orders deadlock")
        out.append(Finding("lock-cycle", "error", site, msg))
    return _sorted(out)


def lint_lock_blocking(scan: ScanResult, graph: Dict[str, Set[str]]
                       ) -> List[Finding]:
    """Blocking calls (direct or transitive) made while a lock is held."""
    # methods with direct blocking calls anywhere in their body (a blocking
    # call with no lock held still makes the METHOD blocking for callers
    # that hold one)
    blocking_methods: Dict[str, str] = {}
    for cls in scan.classes.values():
        for m in cls.methods.values():
            for disp, _ in m.blocking_any:
                blocking_methods.setdefault(m.qualname, disp)
    # propagate: a method that calls a blocking method is blocking
    trans: Dict[str, str] = dict(blocking_methods)
    changed = True
    while changed:
        changed = False
        for q, edges in graph.items():
            if q in trans:
                continue
            for callee in edges:
                if callee in trans:
                    trans[q] = f"{callee.rsplit('.', 1)[1]}->{trans[callee]}"
                    changed = True
                    break
    out = []
    for cls in scan.classes.values():
        for m in cls.methods.values():
            for disp, lineno, locks in m.blocking:
                out.append(Finding(
                    "lock-blocking", "warn",
                    f"{m.qualname}/{disp.rsplit('.', 1)[-1]}",
                    "blocking call %r while holding %s stalls every thread "
                    "needing the lock" % (disp, ", ".join(locks))))
            for held, disp, lineno in m.calls_under_lock:
                callees = {q for q in graph.get(m.qualname, ())
                           if q.rsplit(".", 1)[1] == disp.rsplit(".", 1)[-1]}
                for callee in callees:
                    if callee in trans:
                        out.append(Finding(
                            "lock-blocking", "warn",
                            f"{m.qualname}/{callee.rsplit('.', 1)[1]}",
                            "call reaches blocking %r while holding %s"
                            % (trans[callee], ", ".join(held))))
    # dedupe by fid
    seen: Set[str] = set()
    uniq = [f for f in out if not (f.fid in seen or seen.add(f.fid))]
    return _sorted(uniq)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ConcurrencyReport:
    findings: List[Finding]
    shared: List[SharedAttr]
    entries: List[str]
    reachable: List[str]
    disciplines: Dict[str, str]  # class qualname -> summary

    def to_json(self) -> dict:
        return {
            "findings": [f.to_json() for f in self.findings],
            "shared_state": [s.to_json() for s in self.shared],
            "thread_entry_points": self.entries,
            "reachable_methods": self.reachable,
            "class_disciplines": self.disciplines,
        }


def lint_scan(scan: ScanResult,
              entry_points: Sequence[Tuple[str, Tuple[str, ...]]] = (),
              ) -> ConcurrencyReport:
    """Run every rule over a scan; ``entry_points`` augments auto-detected
    thread roots (same shape as :data:`DEFAULT_ENTRY_POINTS`)."""
    graph = build_call_graph(scan, extra_edges=entry_points)
    entries = thread_entry_points(scan, extra=entry_points)
    reachable = reachable_from(graph, entries)
    shared = shared_state_map(scan, reachable)
    findings = (lint_shared_writes(scan, shared)
                + lint_global_writes(scan, reachable)
                + lint_mixed_guard(scan)
                + lint_lock_cycles(scan, graph)
                + lint_lock_blocking(scan, graph))
    disciplines = {}
    for cls in sorted(scan.classes.values(), key=lambda c: c.qualname):
        bits = []
        if cls.lock_attrs:
            bits.append("lock(%s)" % ",".join(sorted(cls.lock_attrs)))
        if cls.single_writer:
            bits.append("single-writer")
        if cls.thread_local:
            bits.append("thread-local")
        if cls.thread_targets:
            bits.append("spawns(%s)" % ",".join(sorted(cls.thread_targets)))
        if bits:
            disciplines[cls.qualname] = " ".join(bits)
    return ConcurrencyReport(findings=_sorted(findings), shared=shared,
                             entries=entries, reachable=sorted(reachable),
                             disciplines=disciplines)


def lint_runtime(roots: Optional[Sequence[str]] = None,
                 *, src_root: Optional[str] = None) -> ConcurrencyReport:
    """Lint the repo's own runtime (default: all of ``src/repro_torch``)."""
    if src_root is None:
        src_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))  # .../src
    if roots is None:
        roots = [os.path.join(src_root, "repro_torch")]
    scan = scan_paths(roots, root=src_root)
    return lint_scan(scan, entry_points=DEFAULT_ENTRY_POINTS)
