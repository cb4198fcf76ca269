"""Kernel B2: RMSNorm as a hand-written CUDA kernel.

Replaces the JAX package's Pallas TPU kernel (``src/repro/kernels/rmsnorm/
kernel.py`` ``_rmsnorm_kernel`` via ``rms_norm_pallas``). The source is
``src/repro_torch/csrc/rmsnorm.cu``; its header note gives the kernel's
bound on an H100 and what its design does about it. It is built and loaded
by ``kernels/_build.py`` without ``--fmad=false``: a fused multiply-add in
the sum of squares moves y by far less than the tolerances the kernel is
held to (2e-5 in f32, one bf16 ulp in bf16).

A tensor on the CPU takes the plain PyTorch version in ``ref.py``. A CUDA
tensor launches the kernel or raises; nothing falls back. The wrapper
counts its launches in ``rms_norm_cuda.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import KernelLibrary
from repro_torch.kernels.rmsnorm.ref import rms_norm_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_VECTORS = 8 * 256  # 16-byte vectors a row may hold (8 a thread, 256)


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_forward.argtypes = [ptr, ptr, ptr, i32, i32, ctypes.c_float,
                                    i32, ptr]
    lib.rmsnorm_forward.restype = i32


LIBRARY = KernelLibrary("rmsnorm", "rmsnorm.cu", declare=_declare)
load_library = LIBRARY.load


def _on_card(x: torch.Tensor, scale: torch.Tensor) -> bool:
    """Check the operands; True for CUDA tensors, False for CPU tensors."""
    if x.dim() < 1 or scale.dim() != 1 or scale.shape[0] != x.shape[-1]:
        raise ValueError(f"x must be (..., D) and scale (D,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"the RMSNorm kernel takes float32 or bfloat16 x, "
                        f"got {x.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    if x.device != scale.device:
        raise ValueError("x and scale must lie on one device")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no RMSNorm kernel for device {x.device}")
    d = x.shape[-1]
    vec = 16 // x.element_size()
    if d % vec or d // vec > MAX_VECTORS:
        raise ValueError(f"the RMSNorm kernel takes D a multiple of {vec} "
                         f"up to {MAX_VECTORS * vec} for {x.dtype}, got {d}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("the RMSNorm kernel takes contiguous operands")
    if x.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("the RMSNorm kernel takes 16-byte aligned operands")
    return True


def rms_norm_cuda(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-5) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * scale over the last axis, in f32,
    cast back to x's dtype."""
    if not _on_card(x, scale):
        return rms_norm_ref(x, scale, eps=eps)
    lib = load_library()
    y = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d
    if rows == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rmsnorm_forward(x.data_ptr(), scale.data_ptr(),
                                  y.data_ptr(), rows, d, ctypes.c_float(eps),
                                  DTYPES[x.dtype], stream)
    LIBRARY.check(err, "rmsnorm_forward")
    rms_norm_cuda.launches += 1
    return y


rms_norm_cuda.launches = 0


def reset_launches() -> None:
    rms_norm_cuda.launches = 0
