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

Under the dry run (``launch/dryrun.py``) a step runs on fake tensors
(``torch._subclasses.FakeTensor``: shapes, dtypes and no storage) of a fake
world. A wrapper given fake tensors, which lie on the CPU, checks them as
any other, then neither launches nor runs its plain version: it returns
fake outputs of its kernel's shapes and dtypes and adds the kernel's own
flops and bytes (each kernel module's ``cost``) and one launch to the dry
run's count (``count_fake``, inside ``counting_kernels``). Outside a dry
run a fake tensor that reaches a wrapper raises. Real tensors never take
that branch.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterable, Optional

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


@contextlib.contextmanager
def counting_kernels():
    """Within: the wrappers given fake tensors add their kernels' launches,
    flops and bytes to the dict this yields (``count_fake``)."""
    prev = _DRY_RUN["counts"]
    counts: dict = {}
    _DRY_RUN["counts"] = counts
    try:
        yield counts
    finally:
        _DRY_RUN["counts"] = prev


def count_fake(name: str, flops: int, nbytes: int) -> None:
    """One launch of wrapper ``name`` on fake tensors: its kernel's
    ``flops`` and ``nbytes`` into the dry run's count. Raises outside a dry
    run: a fake tensor then has no kernel to run on and no count to go
    to."""
    counts = _DRY_RUN["counts"]
    if counts is None:
        raise RuntimeError(
            f"a fake tensor reached {name} outside a dry run: the kernel "
            f"needs real tensors (the dry run counts its work with "
            f"counting_kernels)")
    with _COUNT_LOCK:
        entry = counts.setdefault(name, {"launches": 0, "flops": 0,
                                         "bytes": 0})
        entry["launches"] += 1
        entry["flops"] += int(flops)
        entry["bytes"] += int(nbytes)


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
        tag = hashlib.sha256(self.source.read_bytes()
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
