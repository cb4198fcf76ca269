"""Kernel B3: the flash-attention forward as a hand-written CUDA kernel.

Replaces the JAX package's Pallas TPU kernel (``src/repro/kernels/
flash_attention/kernel.py`` ``_flash_kernel`` via ``flash_attention_pallas``).
The source is ``src/repro_torch/csrc/flash_attention.cu``; its header note
gives the kernel's bound on an H100 and what its design does about it. It is
built and loaded by ``kernels/_build.py`` without ``--fmad=false``.

Unlike the Pallas wrapper, this one takes any sequence length (the kernel
masks the ragged edge) and K/V with fewer heads than q (GQA: the kernel
reads K/V head h // (H/K) for query head h). Head dims 16, 64 and 128;
float32 or bfloat16.

A tensor on the CPU takes the plain PyTorch version in ``ref.py``. A CUDA
tensor launches the kernel or raises; nothing falls back. The wrapper
counts its launches in ``flash_attention_cuda.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import KernelLibrary
from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128)
MAX_GRID_Y = 65535  # batch * heads: the grid's second axis


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_forward.argtypes = [ptr] * 4 + [i32] * 5 + [
        ctypes.c_float, i32, i32, i32, ptr]
    lib.flash_attention_forward.restype = i32


LIBRARY = KernelLibrary("flash", "flash_attention.cu", declare=_declare)
load_library = LIBRARY.load


def _on_card(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Check the operands; True for CUDA tensors, False for CPU tensors."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B,H,S,D) and k, v (B,K,S,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    kh = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or kh == 0 \
            or h % kh:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}: same B, S, D and K dividing H")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash kernel takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dims {HEAD_DIMS}, "
                         f"got {d}")
    if b * h > MAX_GRID_Y:
        raise ValueError(f"the flash kernel takes B*H <= {MAX_GRID_Y}, got "
                         f"{b * h}")
    ops = (q, k, v)
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("the flash kernel takes contiguous operands")
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError("the flash kernel takes 16-byte aligned operands")
    return True


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Attention forward over q (B,H,S,D) and k, v (B,K,S,D): causal with an
    optional sliding window (k > q - window), or full; scale D^-1/2 unless
    given; output in q's dtype."""
    if not _on_card(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    b, h, s, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            k.shape[1], s, d, ctypes.c_float(scale), int(causal),
            int(window), DTYPES[q.dtype], stream)
    LIBRARY.check(err, "flash_attention_forward")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def reset_launches() -> None:
    flash_attention_cuda.launches = 0
