"""Kernel B3: the flash-attention forward as two hand-written CUDA kernels.

Replaces the JAX package's Pallas TPU kernel (``src/repro/kernels/
flash_attention/kernel.py`` ``_flash_kernel`` via ``flash_attention_pallas``).
The source is ``src/repro_torch/csrc/flash_attention.cu``; its header note
gives the bound on an H100 and what each kernel's design does about it. It
is built and loaded by ``kernels/_build.py`` without ``--fmad=false``.

``kernel_for`` chooses the kernel from dtype and head dim: bfloat16 at head
dims 64, 112 and 128 takes the tensor-core kernel (wgmma, TMA), everything
else (float32, head dim 16) the scalar f32 kernel. The choice is made
before the launch and never after a failure. Every LM family the port
runs attends through it but RWKV: at head dim 128 (llama3.2-3b,
mixtral-8x7b, llava-next-mistral-7b), 112 (zamba2-7b's shared attention)
and 64 (seamless-m4t-medium, causal in its decoder and unmasked in its
encoder); the reduced configs use head dim 16.

Unlike the Pallas wrapper, this one takes any sequence length (the kernels
mask the ragged edge) and K/V with fewer heads than q (GQA: the kernels
read K/V head h // (H/K) for query head h). Head dims 16, 64, 112 and 128;
float32 or bfloat16. The scale is D^-1/2 of the true head dim; the
tensor-core kernel lays D = 112 out in shared memory as 128 columns, of
which the 16 past D are zeros.

A tensor on the CPU takes the plain PyTorch version in ``ref.py``. A CUDA
tensor launches a kernel or raises; nothing falls back. The wrapper counts
every launch in ``flash_attention_cuda.launches`` and the tensor-core
kernel's in ``flash_attention_cuda.launches_tc``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import KernelLibrary, count_launch, \
    reset_counts
from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 112, 128)
TC_HEAD_DIMS = (64, 112, 128)  # of the tensor-core kernel (bf16 only)
MAX_GRID_Y = 65535  # batch * heads: the scalar kernel's second grid axis


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes a CUDA call: ``"tensor_core"`` for bfloat16 at
    head dims 64, 112 and 128, ``"scalar"`` for the rest. f32 stays off the
    tensor cores, whose f32 product would be TF32."""
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return "tensor_core"
    return "scalar"


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_forward.argtypes = [ptr] * 4 + [i32] * 5 + [
        ctypes.c_float, i32, i32, i32, ptr]
    lib.flash_attention_forward.restype = i32
    lib.flash_attention_forward_tc.argtypes = [ptr] * 4 + [i32] * 5 + [
        ctypes.c_float, i32, i32, ptr]
    lib.flash_attention_forward_tc.restype = i32


LIBRARY = KernelLibrary("flash", "flash_attention.cu", declare=_declare)
load_library = LIBRARY.load
_scalar = LIBRARY.launcher("flash_attention_forward")
_tensor_core = LIBRARY.launcher("flash_attention_forward_tc")


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
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            k.shape[1], s, d, scale, int(causal), int(window))
    if kernel_for(q.dtype, d) == "tensor_core":
        _tensor_core(q.get_device(), *args)
        count_launch(flash_attention_cuda, "launches", "launches_tc")
    else:
        _scalar(q.get_device(), *args, DTYPES[q.dtype])
        count_launch(flash_attention_cuda)
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_tc = 0


def reset_launches() -> None:
    reset_counts(flash_attention_cuda, "launches", "launches_tc")
