"""Kernel B1: the Himeno Jacobi sweep as a hand-written CUDA kernel.

Replaces the JAX package's Pallas TPU kernel (``src/repro/kernels/himeno/
kernel.py`` ``_jacobi_kernel`` via ``himeno_jacobi_pallas``). The source is
``src/repro_torch/csrc/himeno.cu``; its header note gives the kernel's bound
on an H100 and the design that follows from it. It is built and loaded by
``kernels/_build.py`` (``nvcc`` for ``sm_90a``, a plain C interface, ctypes),
with ``--fmad=false``.

Two wrappers share the kernel body:

* :func:`himeno_sweep` — ``(p_new, gosa)``, the TPU kernel's function;
  ``ops.himeno_step`` / ``himeno_run`` call it.
* :func:`himeno_stencil` — ``(ss, gosa_partials)``, the interior residual;
  the app's ``jacobi_stencil`` and ``final_residual`` units call it.

A tensor on the CPU takes the plain PyTorch version in ``ref.py``. A CUDA
tensor launches the kernel or raises; nothing falls back. Each wrapper
counts its launches in ``.launches``. A fake tensor, on the CPU or the card
(``kernels/_build.py``), gets fake outputs and its launch recorded
(``record_fake``: the kernel's ``cost`` and ``launch_plan``'s geometry,
which mirrors the source's ``plan_for``), with neither a launch nor the
plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CapturedLaunch, KernelLibrary, \
    Tile, count_launch, fake_on_card, is_fake, record_fake, reset_counts
from repro_torch.kernels.himeno.ref import jacobi_ref, stencil_parts_ref


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.himeno_sweep_f32.argtypes = [ptr] * 8 + [i32] * 3 + [ctypes.c_float,
                                                             ptr]
    lib.himeno_stencil_f32.argtypes = [ptr] * 8 + [i32] * 3 + [ptr]
    for fn in (lib.himeno_sweep_f32, lib.himeno_stencil_f32):
        fn.restype = i32
    lib.himeno_num_partials.argtypes = [i32] * 3
    lib.himeno_num_partials.restype = i32


# --fmad=false: ss = s0*a3 - p cancels to about 1e-4 of p, so a fused
# multiply-add, rounding once where the plain version rounds twice, moves gosa
# by about 1e-4 relative. Unfused, each product and sum rounds as the plain
# PyTorch and NumPy versions round; the sweep is memory-bound either way.
LIBRARY = KernelLibrary("himeno", "himeno.cu", flags=("--fmad=false",),
                        declare=_declare)
load_library = LIBRARY.load


def _on_card(p, a, b, c, bnd, wrk1) -> bool:
    """Check the operands; True for CUDA tensors, False for CPU tensors."""
    if p.dim() != 3 or min(p.shape) < 3:
        raise ValueError(f"p must be (I,J,K) with every side >= 3, got "
                         f"{tuple(p.shape)}")
    shape = tuple(p.shape)
    want = {"a": (4,) + shape, "b": (3,) + shape, "c": (3,) + shape,
            "bnd": shape, "wrk1": shape}
    for name, t in zip(("a", "b", "c", "bnd", "wrk1"), (a, b, c, bnd, wrk1)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
    ops = (p, a, b, c, bnd, wrk1)
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError("the Himeno kernel takes float32 operands")
    if any(t.device != p.device for t in ops):
        raise ValueError("all operands must lie on one device")
    if p.device.type == "cpu":
        return False
    if p.device.type != "cuda":
        raise ValueError(f"no Himeno kernel for device {p.device}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("the Himeno kernel takes contiguous operands")
    return True


TK, TJ, ICHUNK = 32, 8, 32  # a block's tile (k, j) and its planes along i


def cost(shape) -> tuple[int, int]:
    """(flops, bytes) of a sweep over (I, J, K): 13 f32 arrays read and one
    written, 56 bytes a point; 34 operations a point (the source's header
    note)."""
    n = shape[0] * shape[1] * shape[2]
    return 34 * n, 56 * n


def launch_plan(shape, *, sweep: bool = True) -> list[CapturedLaunch]:
    """The launch ``himeno_sweep`` (or ``himeno_stencil``) makes over p of
    ``shape`` (I, J, K), as the source's ``plan_for`` makes it: a block a
    (TJ, TK) tile of (j, k) through ICHUNK planes of i, a gosa partial a
    block. The stencil's ss, the interior, lies one point off the blocks'
    tiles and is held as one tile."""
    I, J, K = shape
    grid = (-(-K // TK), -(-J // TJ), -(-I // ICHUNK))
    f32 = torch.float32
    tile = (ICHUNK, TJ, TK)
    at = (lambda x, y, z: (z, y, x))

    def coef(name, n):
        return Tile(name, (n, I, J, K), f32, (n,) + tile,
                    lambda x, y, z: (0, z, y, x))

    ops = [Tile("p", shape, f32, tile, at), coef("a", 4), coef("b", 3),
           coef("c", 3), Tile("bnd", shape, f32, tile, at),
           Tile("wrk1", shape, f32, tile, at)]
    if sweep:
        ops.append(Tile("p_new", shape, f32, tile, at, written=True))
    else:
        ss = (I - 2, J - 2, K - 2)
        ops.append(Tile("ss", ss, f32, ss, lambda x, y, z: (0, 0, 0),
                        written=True))
    n = grid[0] * grid[1] * grid[2]
    ops.append(Tile("parts", (n,), f32, (1,),
                    lambda x, y, z: ((z * grid[1] + y) * grid[0] + x,),
                    written=True))
    threads = TK * TJ
    return [CapturedLaunch(
        "himeno_kernel", grid, (TK, TJ, 1), 0, False, threads, ops, LIBRARY,
        (0 if sweep else 1, I, J, K, 0, 0, 0, 0))]


def _fake(sweep: bool, p, a, b, c, bnd, wrk1):
    """A sweep or stencil on fake tensors: its launch recorded, fake
    outputs."""
    shape = tuple(p.shape)
    record_fake("himeno_sweep" if sweep else "himeno_stencil", *cost(shape),
                (p, a, b, c, bnd, wrk1),
                lambda: launch_plan(shape, sweep=sweep))
    I, J, K = shape
    n = -(-K // TK) * -(-J // TJ) * -(-I // ICHUNK)
    parts = torch.empty((n,), dtype=p.dtype, device=p.device)
    if sweep:
        return torch.empty_like(p), parts.sum()
    return torch.empty((I - 2, J - 2, K - 2), dtype=p.dtype,
                       device=p.device), parts


_sweep = LIBRARY.launcher("himeno_sweep_f32")
_stencil = LIBRARY.launcher("himeno_stencil_f32")


def _launch(launch, out, p, a, b, c, bnd, wrk1, *extra):
    I, J, K = p.shape
    parts = torch.empty(load_library().himeno_num_partials(I, J, K),
                        dtype=torch.float32, device=p.device)
    launch(p.get_device(), p.data_ptr(), a.data_ptr(), b.data_ptr(),
           c.data_ptr(), bnd.data_ptr(), wrk1.data_ptr(), out.data_ptr(),
           parts.data_ptr(), I, J, K, *extra)
    return parts


def himeno_sweep(p, a, b, c, bnd, wrk1, omega: float = 0.8):
    """One Jacobi sweep: (p_new, gosa), boundaries of p passed through."""
    if not _on_card(p, a, b, c, bnd, wrk1):
        if is_fake(p):
            return _fake(True, p, a, b, c, bnd, wrk1)
        return jacobi_ref(p, a, b, c, bnd, wrk1, omega=omega)
    if fake_on_card(p):
        return _fake(True, p, a, b, c, bnd, wrk1)
    p_new = torch.empty_like(p)
    parts = _launch(_sweep, p_new, p, a, b, c, bnd, wrk1, omega)
    count_launch(himeno_sweep)
    return p_new, torch.sum(parts)


def himeno_stencil(p, a, b, c, bnd, wrk1):
    """The interior residual ss (I-2,J-2,K-2) and gosa partials; their sum
    is gosa."""
    if not _on_card(p, a, b, c, bnd, wrk1):
        if is_fake(p):
            return _fake(False, p, a, b, c, bnd, wrk1)
        return stencil_parts_ref(p, a, b, c, bnd, wrk1)
    if fake_on_card(p):
        return _fake(False, p, a, b, c, bnd, wrk1)
    I, J, K = p.shape
    ss = torch.empty((I - 2, J - 2, K - 2), dtype=p.dtype, device=p.device)
    parts = _launch(_stencil, ss, p, a, b, c, bnd, wrk1)
    count_launch(himeno_stencil)
    return ss, parts


himeno_sweep.launches = 0
himeno_stencil.launches = 0
WRAPPERS = (himeno_sweep, himeno_stencil)


def reset_launches() -> None:
    for fn in WRAPPERS:
        reset_counts(fn)
