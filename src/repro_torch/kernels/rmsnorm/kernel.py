"""Kernel B2: RMSNorm as a hand-written CUDA kernel, and its gradient as a
second.

Replaces the JAX package's Pallas TPU kernel (``src/repro/kernels/rmsnorm/
kernel.py`` ``_rmsnorm_kernel`` via ``rms_norm_pallas``). The source is
``src/repro_torch/csrc/rmsnorm.cu``; its header note gives the kernel's
bound on an H100 and what its design does about it. It is built and loaded
by ``kernels/_build.py`` without ``--fmad=false``: a fused multiply-add in
the sum of squares moves y by far less than the tolerances the kernel is
held to (2e-5 in f32, one bf16 ulp in bf16).

A tensor on the CPU takes the plain PyTorch version in ``ref.py``. A CUDA
tensor launches the kernel or raises; nothing falls back. The wrapper
counts its launches in ``rms_norm_cuda.launches``. A fake tensor, on the
CPU or the card (``kernels/_build.py``), gets a fake output and its launch
recorded (``record_fake``: the kernel's ``cost``, and ``launch_plan``'s
geometry, which mirrors ``forward_plan``, ``backward_plan`` and
``dscale_plan`` in the source), with neither a launch nor the plain
version.

``rms_norm_backward_cuda`` launches the gradient (``rmsnorm_backward`` in
the source, two kernels: dx with each block's partial dscale, then the
partials summed over the blocks in a fixed order); its plain version is
``rms_norm_backward_ref``. It takes x and g of one dtype (bf16 or f32) and
the forward's D limits, and counts its launches in
``rms_norm_backward_cuda.launches``.

The launch path is short, since a decode step calls it 49 or 57 times and
its time there is the host's (``chip_smoke.py``'s ``rms_host_path`` phase
times each step of it on the card): the checks are ordered cheapest first
and read no ``torch.device``, and each pointer is read once; the
library's launcher, bound once, reads the raw stream handle and switches
device only when x is not on the current one; the seven arguments go to
the kernel packed into one buffer by ``struct`` (``RmsArgs`` in the
source), which ctypes passes as one pointer instead of converting each;
the error check is one comparison when the launch succeeds. A fake tensor
leaves it where its pointer reads 0, inside the alignment test.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import Optional

import torch

from repro_torch.kernels._build import CapturedLaunch, KernelLibrary, \
    Tile, count_launch, fake_on_card, is_fake, record_fake, reset_counts
from repro_torch.kernels.rmsnorm.ref import (rms_norm_backward_ref,
                                             rms_norm_ref)

BLOCK = 256  # threads of a block but for the narrowest rows' 32
MAX_VECTORS = 8 * BLOCK  # 16-byte vectors a row may hold (8 a thread)
DS_COLS, DS_GROUPS = 32, 8  # the gradient's dscale kernel: columns, warps
# SMs of an H100 and its most resident threads an SM: where no card can be
# asked, the gradient's grid of a plan (``backward_blocks``) is taken as
# the blocks of its size these admit
H100_SMS, SM_THREADS = 132, 2048
# RmsArgs in rmsnorm.cu: x, scale, y, rows, d, eps (f32), dtype (0 = f32,
# 1 = bf16), in native byte order without padding
_pack = struct.Struct("=QQQiifi").pack
# RmsBackArgs: x, scale, g, dx, partial, dscale; rows, d, eps, dtype, blocks
# and a pad
_pack_backward = struct.Struct("=6Qiifiii").pack


def _declare(lib: ctypes.CDLL) -> None:
    for name in ("rmsnorm_forward", "rmsnorm_backward"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.rmsnorm_backward_blocks.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int)]
    lib.rmsnorm_backward_blocks.restype = ctypes.c_int


LIBRARY = KernelLibrary("rmsnorm", "rmsnorm.cu", declare=_declare)
load_library = LIBRARY.load
_forward = LIBRARY.launcher("rmsnorm_forward")
_backward = LIBRARY.launcher("rmsnorm_backward")


def cost(shape, dtype_bytes: int) -> tuple[int, int]:
    """(flops, bytes) of the forward over x of ``shape`` in a dtype of
    ``dtype_bytes``: x read once, y written once, scale (f32) read once; 4
    f32 operations an element (square, sum, and two products)."""
    n = 1
    for side in shape:
        n *= side
    return 4 * n, 2 * n * dtype_bytes + 4 * shape[-1]


def backward_cost(shape, dtype_bytes: int) -> tuple[int, int]:
    """(flops, bytes) of the gradient: x and the cotangent g read once, dx
    written once, scale (f32) read and dscale (f32) written once; ~10 f32
    operations an element (the row's sum of squares and of g x scale, dx's
    products, and dscale's sum)."""
    n = 1
    for side in shape:
        n *= side
    return 10 * n, 3 * n * dtype_bytes + 8 * shape[-1]


def _vectors(d: int, dtype: torch.dtype) -> int:
    """16-byte vectors a row of ``d`` elements of ``dtype`` holds."""
    return d // (8 if dtype is torch.bfloat16 else 4)


def launch_plan(shape, dtype: torch.dtype, *, backward: bool = False,
                blocks: Optional[int] = None) -> list[CapturedLaunch]:
    """The launches ``rms_norm_cuda`` (or, with ``backward``,
    ``rms_norm_backward_cuda``) makes over x of ``shape`` and ``dtype``, as
    the source's ``forward_plan`` (and ``backward_plan``, ``dscale_plan``)
    makes them: a block a row, of 32 threads up to 32 vectors a row, else
    256; the gradient on ``blocks`` blocks (None: the wrapper's
    ``backward_blocks`` on the card, else ``H100_SMS`` times the blocks of
    its size an SM holds), each taking every ``blocks``-th row, then one
    block each 32 columns of dscale."""
    d = shape[-1]
    rows = 1
    for side in shape[:-1]:
        rows *= side
    nvec = _vectors(d, dtype)
    code = int(dtype is torch.bfloat16)
    rows_of = (lambda x, y, z: (x, 0))
    if not backward:
        threads = 32 if nvec <= 32 else BLOCK
        return [CapturedLaunch(
            "rmsnorm_forward", (rows, 1, 1), (threads, 1, 1), 0, False,
            threads,
            [Tile("x", (rows, d), dtype, (1, d), rows_of),
             Tile("scale", (d,), torch.float32, (d,), lambda x, y, z: (0,)),
             Tile("y", (rows, d), dtype, (1, d), rows_of, written=True)],
            LIBRARY, (0, rows, d, code, 0, 0, 0, 0))]
    threads = 32 if nvec <= 32 else 128 if nvec <= 128 else BLOCK
    if blocks is None:
        blocks = (backward_blocks(0, d, bool(code))
                  if torch.cuda.is_available()
                  else H100_SMS * min(SM_THREADS // threads, 32))
    blocks = min(rows, blocks)

    def strided(x, y, z):  # the rows a block of the persistent grid takes
        return [(r, 0) for r in range(x, rows, blocks)]

    scale = Tile("scale", (d,), torch.float32, (d,), lambda x, y, z: (0,))
    return [
        CapturedLaunch(
            "rmsnorm_backward", (blocks, 1, 1), (threads, 1, 1), 0, False,
            threads,
            [Tile("x", (rows, d), dtype, (1, d), strided), scale,
             Tile("g", (rows, d), dtype, (1, d), strided),
             Tile("dx", (rows, d), dtype, (1, d), strided, written=True),
             Tile("partial", (blocks, d), torch.float32, (1, d), rows_of,
                  written=True)],
            LIBRARY, (1, rows, d, code, blocks, 0, 0, 0)),
        CapturedLaunch(
            "rmsnorm_dscale", (-(-d // DS_COLS), 1, 1),
            (DS_COLS * DS_GROUPS, 1, 1), 0, False, DS_COLS * DS_GROUPS,
            [Tile("partial", (blocks, d), torch.float32, (blocks, DS_COLS),
                  lambda x, y, z: (0, x)),
             Tile("dscale", (d,), torch.float32, (DS_COLS,),
                  lambda x, y, z: (x,), written=True)],
            LIBRARY, (2, rows, d, code, blocks, 0, 0, 0))]


def _fake(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The forward on fake tensors: its launch recorded, a fake y."""
    if x.numel():
        record_fake("rms_norm", *cost(x.shape, x.element_size()), (x, scale),
                    lambda: launch_plan(tuple(x.shape), x.dtype))
    return torch.empty_like(x)


def _on_card(x: torch.Tensor, scale: torch.Tensor) -> int:
    """Check the operands (all but their alignment, which the wrapper checks
    on the pointers it passes); return the CUDA device index for tensors on
    the card, -1 for tensors on the CPU.

    Cheapest first on the card's path: ``is_cuda`` and ``get_device()``
    instead of building ``torch.device`` objects, which only the refusals
    and the CPU need."""
    if x.dim() < 1 or scale.shape != (x.shape[-1],):
        raise ValueError(f"x must be (..., D) and scale (D,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    dtype = x.dtype
    if dtype is not torch.bfloat16 and dtype is not torch.float32:
        raise TypeError(f"the RMSNorm kernel takes float32 or bfloat16 x, "
                        f"got {dtype}")
    if scale.dtype is not torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    if not x.is_cuda:
        if x.device != scale.device:
            raise ValueError("x and scale must lie on one device")
        if x.device.type == "cpu":
            return -1
        raise ValueError(f"no RMSNorm kernel for device {x.device}")
    device = x.get_device()
    if scale.get_device() != device:  # -1 off the card
        raise ValueError("x and scale must lie on one device")
    d = x.shape[-1]
    vec = 8 if dtype is torch.bfloat16 else 4  # elements of 16 bytes
    if d % vec or d // vec > MAX_VECTORS:
        raise ValueError(f"the RMSNorm kernel takes D a multiple of {vec} "
                         f"up to {MAX_VECTORS * vec} for {dtype}, got {d}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("the RMSNorm kernel takes contiguous operands")
    return device


def rms_norm_cuda(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-5) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * scale over the last axis, in f32,
    cast back to x's dtype."""
    device = _on_card(x, scale)
    if device < 0:
        if is_fake(x):
            return _fake(x, scale)
        return rms_norm_ref(x, scale, eps=eps)
    try:
        xp, sp = x.data_ptr(), scale.data_ptr()
    except RuntimeError:  # a fake tensor's, where reading it raises
        xp = sp = 0
    if xp % 16 or sp % 16 or not xp:
        if is_fake(x):
            return _fake(x, scale)
        if xp % 16 or sp % 16:
            raise ValueError("the RMSNorm kernel takes 16-byte aligned "
                             "operands")
    y = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d
    if rows:
        _forward(device, _pack(xp, sp, y.data_ptr(), rows, d, eps,
                               x.dtype is torch.bfloat16))
        count_launch(rms_norm_cuda)
    return y


rms_norm_cuda.launches = 0


@functools.lru_cache(maxsize=None)
def backward_blocks(device: int, d: int, bf16: bool) -> int:
    """The gradient's most blocks at once on CUDA device ``device`` for rows
    of ``d`` elements: its persistent grid, and the rows of partial dscale
    it writes."""
    out = ctypes.c_int()
    with torch.cuda.device(device):
        LIBRARY.check(LIBRARY.load().rmsnorm_backward_blocks(
            d, int(bf16), ctypes.byref(out)), "rmsnorm_backward_blocks")
    return out.value


def rms_norm_backward_cuda(x: torch.Tensor, scale: torch.Tensor,
                           g: torch.Tensor, *, eps: float = 1e-5
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of y = rms_norm_cuda(x, scale) for the cotangent g of y
    (x's shape and dtype): dx in x's dtype, dscale f32 (D,). CUDA tensors
    launch the gradient kernel, CPU tensors take ``rms_norm_backward_ref``.
    Deterministic: dscale's partial sums are added in a fixed order."""
    device = _on_card(x, scale)
    if g.shape != x.shape or g.dtype is not x.dtype:
        raise ValueError(f"g must have x's shape {tuple(x.shape)} and dtype "
                         f"{x.dtype}, got {tuple(g.shape)} {g.dtype}")
    if device < 0:
        if g.device != x.device:
            raise ValueError("x and g must lie on one device")
        if is_fake(x):
            return _fake_backward(x, scale, g)
        return rms_norm_backward_ref(x, scale, g, eps)
    if g.get_device() != device:
        raise ValueError("x and g must lie on one device")
    if not g.is_contiguous():
        raise ValueError("the RMSNorm gradient kernel takes a contiguous g")
    if fake_on_card(x):
        return _fake_backward(x, scale, g)
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    if not rows:
        return dx, dscale.zero_()
    bf16 = x.dtype is torch.bfloat16
    blocks = min(rows, backward_blocks(device, d, bf16))
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), dscale.data_ptr())
    if any(p % 16 for p in ptrs):
        raise ValueError("the RMSNorm gradient kernel takes 16-byte aligned "
                         "operands")
    _backward(device, _pack_backward(*ptrs, rows, d, eps, bf16, blocks, 0))
    count_launch(rms_norm_backward_cuda)
    return dx, dscale


rms_norm_backward_cuda.launches = 0


def _fake_backward(x, scale, g):
    """The gradient on fake tensors: its launches recorded, fake dx and
    dscale."""
    if x.numel():
        record_fake("rms_norm_backward",
                    *backward_cost(x.shape, x.element_size()), (x, scale, g),
                    lambda: launch_plan(tuple(x.shape), x.dtype,
                                        backward=True))
    return (torch.empty_like(x),
            torch.empty((x.shape[-1],), dtype=torch.float32,
                        device=x.device))


def reset_launches() -> None:
    reset_counts(rms_norm_cuda)
    reset_counts(rms_norm_backward_cuda)
