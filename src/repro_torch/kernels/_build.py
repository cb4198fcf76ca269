"""Build and load the port's CUDA kernels: one helper for every source.

Each kernel source under ``src/repro_torch/csrc/`` has a plain C interface.
It is compiled with ``nvcc`` for ``sm_90a`` into a shared library at first
use, into ``build/kernels/`` at the repo root (listed in ``.gitignore``),
under a name that carries the hash of the source and the flags, and loaded
with ctypes. A build writes a temporary file and renames it into place, so
two processes that build at once never load half a library. Every library
exports ``<prefix>_error_string(int)``, CUDA's name for an error code.
"""
from __future__ import annotations

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
        """Build (first use) and load the library; raises without CUDA."""
        if self._lib is not None:
            return self._lib
        if not torch.cuda.is_available():
            raise RuntimeError(f"the {self.prefix} CUDA kernel needs a CUDA "
                               "device")
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                err = getattr(lib, f"{self.prefix}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._declare(lib)
                self._lib = lib
        return self._lib

    def check(self, err: int, what: str) -> None:
        """Raise if a launch returned a CUDA error."""
        if err != 0:
            name = getattr(self.load(), f"{self.prefix}_error_string")(err)
            raise RuntimeError(f"{what} launch failed: {name.decode()}")


def build_all(libraries: Iterable[KernelLibrary]) -> dict[str, float]:
    """Build several libraries at once, one ``nvcc`` each, all started
    together; return each build's seconds by prefix."""
    def timed(lib: KernelLibrary) -> tuple[str, float]:
        t0 = time.perf_counter()
        lib.build()
        return lib.prefix, time.perf_counter() - t0

    libs = list(libraries)
    with ThreadPoolExecutor(max_workers=max(len(libs), 1)) as pool:
        return dict(pool.map(timed, libs))
