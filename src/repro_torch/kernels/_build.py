"""Build and load the port's CUDA kernels: one helper for every source.

Each kernel source under ``src/repro_torch/csrc/`` has a plain C interface.
It is compiled with ``nvcc`` for ``sm_90a`` into a shared library at first
use, into ``build/kernels/`` at the repo root (listed in ``.gitignore``),
under a name that carries the hash of the source and the flags, and loaded
with ctypes. A build writes a temporary file and renames it into place, so
two processes that build at once never load half a library. Every library
exports ``<prefix>_error_string(int)``, CUDA's name for an error code. Every
wrapper launches through ``KernelLibrary.launcher``, on PyTorch's current
stream of the operands' device, and counts the launch with
``count_launch``, which stays exact when engines step on several threads.

A wrapper given fake tensors (``torch._subclasses.FakeTensor``: shapes,
dtypes and no storage), on the CPU or on the card, checks them as any
other but for the alignment of their pointers, then neither launches nor
runs its plain version: it returns fake outputs of its kernel's shapes and
dtypes and records the launch with ``record_fake``, which hands it to
whichever of three readers is active:

* the dry run (``launch/dryrun.py``, inside ``counting_kernels``): the
  kernel's own flops and bytes (each kernel module's ``cost``) and one
  launch;
* the graph walker (``analysis/graph_walk.py``, inside ``walking_graphs``):
  one ``repro_torch::launch`` node in the traced graph, with the kernel's
  name, flops, bytes and operands;
* the kernel lint (``analysis/kernel_lint.py``, inside ``capturing``): each
  launch's geometry as the kernel module's ``launch_plan`` gives it, a
  ``CapturedLaunch`` a launch of the CUDA source.

Outside all three a fake tensor that reaches a wrapper raises. Real tensors
never take that branch: a CPU tensor reaches it only after the device test
sends it off the card path, a CUDA tensor only where its pointer reads 0,
which no real operand's does.

Each source also exports ``<prefix>_plan`` and ``<prefix>_attributes``
(``csrc/launch_plan.h``): the geometry its launchers launch by, computed by
the function they use, and the kernel's registers, memory and blocks an SM
(``plan_on_card``, ``attributes_on_card``).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# The current CUDA device's index and the raw handle of a device's current
# stream, read without building torch.device or torch.cuda.Stream objects;
# a build of PyTorch without CUDA has neither (and launches nothing).
_current_device = getattr(torch._C, "_cuda_getDevice", None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


# One lock for every wrapper's launch counts: ``fn.launches += 1`` is a
# read, an add and a write, and a thread switch between them loses a count.
_COUNT_LOCK = threading.Lock()


def count_launch(fn, *names: str) -> None:
    """Add one to each of ``fn``'s integer attributes ``names`` (default
    ``launches``) under a lock, so that concurrent launches are all counted.
    Readers read the attribute as a plain int."""
    with _COUNT_LOCK:
        for name in names or ("launches",):
            setattr(fn, name, getattr(fn, name) + 1)


def reset_counts(fn, *names: str) -> None:
    """Set each of ``fn``'s counts ``names`` (default ``launches``) to 0."""
    with _COUNT_LOCK:
        for name in names or ("launches",):
            setattr(fn, name, 0)


# The dry run's count of each kernel's work: {wrapper name: {"launches",
# "flops", "bytes"}} inside ``counting_kernels``, None outside.
_DRY_RUN: dict = {"counts": None}


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (shapes and dtypes, no storage)."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def fake_on_card(t: torch.Tensor) -> bool:
    """Whether ``t``, a tensor on the card path, is fake: its pointer reads
    0 (or raises), which a real operand's never does, and it is a
    ``FakeTensor``. For launch paths that are not host-bound; the host-bound
    ones test the pointers they read anyway."""
    try:
        if t.data_ptr():
            return False
    except RuntimeError:
        pass
    return is_fake(t)


@contextlib.contextmanager
def counting_kernels():
    """Within: the wrappers given fake tensors add their kernels' launches,
    flops and bytes to the dict this yields (``record_fake``)."""
    prev = _DRY_RUN["counts"]
    counts: dict = {}
    _DRY_RUN["counts"] = counts
    try:
        yield counts
    finally:
        _DRY_RUN["counts"] = prev


# ---------------------------------------------------------------------------
# A launch's geometry, for the kernel lint
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Tile:
    """One operand of a launch and the part of it each block touches: the
    block at (x, y, z) of the grid touches the tile of ``block`` elements
    whose index along each axis ``index(x, y, z)`` gives (start = index *
    block, the last tile cut at the operand's edge, as the kernels mask
    it), or each of the tiles in the list it gives (a block that loops).
    ``written``: the kernel writes it; ``alias``: the name of the operand
    it also is (written in place)."""

    name: str
    shape: tuple
    dtype: Any
    block: tuple
    index: Callable[[int, int, int], Any]
    written: bool = False
    alias: Optional[str] = None


@dataclasses.dataclass
class CapturedLaunch:
    """One launch of a CUDA kernel as its launcher makes it: the kernel's
    name, grid and block (x, y, z), dynamic shared memory in bytes, whether
    the launcher raises the kernel's dynamic shared memory limit
    (``cudaFuncSetAttribute``, which above 48 KB it must), the kernel's
    ``__launch_bounds__``, its operands' tiles, and the ``<prefix>_plan``
    arguments under which the library reports the same launch
    (``library``: the kernel module's ``LIBRARY``)."""

    kernel_name: str
    grid: tuple
    block: tuple
    smem: int
    opt_in: bool
    launch_bounds: int
    operands: list
    library: Any = None
    plan_args: tuple = ()

    @property
    def operand_shapes(self) -> list:
        return [tuple(t.shape) for t in self.operands]

    @property
    def operand_dtypes(self) -> list:
        return [t.dtype for t in self.operands]


def plan_on_card(launch: CapturedLaunch) -> tuple:
    """(grid, block, smem) of ``launch`` as its library's ``<prefix>_plan``
    gives them on the current device."""
    lib = launch.library
    out = (ctypes.c_int * 7)()
    args = (ctypes.c_int * 8)(*launch.plan_args)
    lib.check(getattr(lib.load(), f"{lib.prefix}_plan")(args, out),
              f"{lib.prefix}_plan")
    return tuple(out[0:3]), tuple(out[3:6]), out[6]


ATTRIBUTES = ("registers", "local_bytes", "static_smem", "max_dynamic_smem",
              "max_threads", "blocks_per_sm")


def attributes_on_card(launch: CapturedLaunch) -> dict:
    """The kernel's attributes on the current device (``ATTRIBUTES``:
    ``cudaFuncGetAttributes``' registers a thread, local bytes a thread,
    static and most dynamic shared bytes, most threads a block) and its
    blocks an SM at ``launch``'s geometry
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = launch.library
    out = (ctypes.c_int * 6)()
    args = (ctypes.c_int * 8)(*launch.plan_args)
    lib.check(getattr(lib.load(), f"{lib.prefix}_attributes")(args, out),
              f"{lib.prefix}_attributes")
    return dict(zip(ATTRIBUTES, out))


# ---------------------------------------------------------------------------
# Fake tensors' launches and their readers
# ---------------------------------------------------------------------------

_READERS: dict = {"walk": 0, "capture": None}


@contextlib.contextmanager
def walking_graphs():
    """Within: the wrappers given fake tensors add a ``repro_torch::launch``
    node to the graph being traced (``launch_op``)."""
    launch_op()
    _READERS["walk"] += 1
    try:
        yield
    finally:
        _READERS["walk"] -= 1


@contextlib.contextmanager
def capturing():
    """Within: the wrappers given fake tensors append each launch they
    would make (a ``CapturedLaunch``) to the list this yields."""
    prev = _READERS["capture"]
    captured: list = []
    _READERS["capture"] = captured
    try:
        yield captured
    finally:
        _READERS["capture"] = prev


_LAUNCH_OP: dict = {}


def launch_op():
    """``torch.ops.repro_torch.launch(name, flops, nbytes, operands)``: an
    op that does nothing, through which a kernel's launch on fake tensors
    becomes a node of a traced graph (defined at the first call)."""
    op = _LAUNCH_OP.get("op")
    if op is None:
        @torch.library.custom_op("repro_torch::launch", mutates_args=())
        def op(name: str, flops: int, nbytes: int,
               operands: list[torch.Tensor]) -> None:
            return None

        @op.register_fake
        def _(name, flops, nbytes, operands):
            return None

        _LAUNCH_OP["op"] = op
    return op


def record_fake(name: str, flops: int, nbytes: int, operands: tuple,
                plan: Callable[[], list]) -> None:
    """One launch of wrapper ``name`` on fake tensors ``operands``: its
    kernel's ``flops`` and ``nbytes`` to the dry run, a node to the graph
    walker, and ``plan()`` (the launches' ``CapturedLaunch``es) to the
    kernel lint, each if active. Raises where none is: a fake tensor then
    has no kernel to run on and no reader to go to."""
    counts, captured = _DRY_RUN["counts"], _READERS["capture"]
    if counts is None and captured is None and not _READERS["walk"]:
        raise RuntimeError(
            f"a fake tensor reached {name} outside a dry run, a graph walk "
            f"or a launch capture: the kernel needs real tensors (the dry "
            f"run counts its work with counting_kernels)")
    if counts is not None:
        with _COUNT_LOCK:
            entry = counts.setdefault(name, {"launches": 0, "flops": 0,
                                             "bytes": 0})
            entry["launches"] += 1
            entry["flops"] += int(flops)
            entry["bytes"] += int(nbytes)
    if _READERS["walk"]:
        torch.ops.repro_torch.launch(name, int(flops), int(nbytes),
                                     list(operands))
    if captured is not None:
        captured.extend(plan())


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           f"from {CSRC} with the CUDA toolkit")
    return path


class KernelLibrary:
    """One CUDA source, built once and loaded once per process.

    ``declare`` sets ``argtypes``/``restype`` of the library's functions;
    ``flags`` are added to ``BASE_FLAGS`` (for instance ``--fmad=false``
    where a kernel must round as its plain version does)."""

    def __init__(self, prefix: str, source: str, *,
                 flags: tuple[str, ...] = (),
                 declare: Callable[[ctypes.CDLL], None]):
        self.prefix = prefix
        self.source = CSRC / source
        self.flags = BASE_FLAGS + tuple(flags)
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        # the headers beside the sources too (launch_plan.h)
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.h")))
        tag = hashlib.sha256(self.source.read_bytes() + headers
                             + " ".join(self.flags).encode()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.prefix}-{tag}.so"

    def build(self) -> Path:
        """Compile the source unless a library of the same source and flags
        is there already; return the library's path."""
        out = self.path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}."
                            f"{threading.get_ident()}.tmp")
        res = subprocess.run([nvcc(), *self.flags, "-o", str(tmp),
                              str(self.source)], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source}:\n{res.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
        return out

    def load(self) -> ctypes.CDLL:
        """Build (first use) and load the library; raises without CUDA.

        ``_lib`` is read and written under ``_lock`` only, and the lock is
        never held across the build (nvcc) or the load: two threads that
        both find no library may both build and load it, which ``build``
        makes safe, and the first to publish wins. Launches pay for none of
        this, since ``launcher`` binds its function at the first launch."""
        with self._lock:
            lib = self._lib
        if lib is not None:
            return lib
        if not torch.cuda.is_available():
            raise RuntimeError(f"the {self.prefix} CUDA kernel needs a CUDA "
                               "device")
        lib = ctypes.CDLL(str(self.build()))
        err = getattr(lib, f"{self.prefix}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        for what in ("plan", "attributes"):  # every source's, launch_plan.h
            fn = getattr(lib, f"{self.prefix}_{what}")
            fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
            fn.restype = ctypes.c_int
        self._declare(lib)
        with self._lock:
            if self._lib is None:
                self._lib = lib
            return self._lib

    def launcher(self, name: str) -> Callable[..., None]:
        """A function ``launch(device, *args)`` that calls the library's
        function ``name`` with ``args`` and, last, the current stream of
        CUDA device ``device`` (an index, as ``Tensor.get_device()`` gives
        it), and raises if it returns an error. The library is loaded at
        the first launch.

        The launch path of every kernel, kept short because decode calls
        it thousands of times a step: the function bound once, the raw
        stream handle without a ``Stream`` object, the device switched only
        when ``device`` is not the current one, arguments converted by the
        declared ``argtypes``."""
        fn = None

        def launch(device: int, *args) -> None:
            nonlocal fn
            if fn is None:
                fn = getattr(self.load(), name)
            if device == _current_device():
                err = fn(*args, _raw_stream(device))
            else:
                with torch.cuda.device(device):
                    err = fn(*args, _raw_stream(device))
            if err:
                self.check(err, name)

        return launch

    def check(self, err: int, what: str) -> None:
        """Raise if a launch returned a CUDA error."""
        if err != 0:
            name = getattr(self.load(), f"{self.prefix}_error_string")(err)
            raise RuntimeError(f"{what} launch failed: {name.decode()}")


def build_all(libraries: Iterable[KernelLibrary]) -> dict[str, float]:
    """Build several libraries at once, one ``nvcc`` each, all started
    together; return each build's seconds by library file name (one source
    may be built with two sets of flags)."""
    def timed(lib: KernelLibrary) -> tuple[str, float]:
        t0 = time.perf_counter()
        lib.build()
        return lib.path().name, time.perf_counter() - t0

    libs = list(libraries)
    with ThreadPoolExecutor(max_workers=max(len(libs), 1)) as pool:
        return dict(pool.map(timed, libs))
