"""Kernel B4: the RWKV6 WKV recurrence as a hand-written CUDA kernel.

Replaces the JAX package's Pallas TPU kernel (``src/repro/kernels/wkv/
kernel.py`` ``_wkv_kernel`` via ``wkv_pallas``). The source is
``src/repro_torch/csrc/wkv.cu``; its header note gives the kernel's bound on
an H100 and what its design does about it. It is built and loaded by
``kernels/_build.py`` without ``--fmad=false``: fused multiply-adds move out
by rounding only (about 1e-7 of max |out| on the card), far below the 1e-5
of max |out| and of max |state| the kernel is held to against ``wkv_ref``.

Unlike the Pallas wrapper, this one computes the sequential recurrence of
``wkv_ref`` (no chunked form that overflows under strong decay), takes any
S >= 1 and an optional initial state, which it updates in place: a decode
step carries its state from step to step without a copy. r, k, v and lw are
float32 with any strides whose last is 1 (the model hands over views of its
(B, S, H, D) products); head dims 16 (the reduced config) and 64
(rwkv6-1.6b).

A tensor on the CPU takes the plain PyTorch version in ``ref.py``. A CUDA
tensor launches the kernel or raises; nothing falls back. The wrapper
counts its launches in ``wkv_cuda.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import KernelLibrary
from repro_torch.kernels.wkv.ref import wkv_ref

HEAD_DIMS = (16, 64)
MAX_GRID_Y = 65535  # batch * heads: the grid's second axis
I64X3 = ctypes.c_int64 * 3


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wkv_forward.argtypes = [ptr] * 8 + [i32] * 4 + [ptr, ptr, ptr]
    lib.wkv_forward.restype = i32


LIBRARY = KernelLibrary("wkv", "wkv.cu", declare=_declare)
load_library = LIBRARY.load
_forward = LIBRARY.launcher("wkv_forward")


def _check(r, k, v, lw, u, state) -> bool:
    """Check the operands; True for CUDA tensors, False for CPU tensors."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, lw)):
        raise ValueError(f"r, k, v, lw must be (B,H,S,D) of one shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, lw)]}")
    b, h, s, d = r.shape
    if tuple(u.shape) != (h, d):
        raise ValueError(f"u must be (H, D) = {(h, d)}, got {tuple(u.shape)}")
    if state is not None and tuple(state.shape) != (b, h, d, d):
        raise ValueError(f"state must be (B,H,D,D) = {(b, h, d, d)}, got "
                         f"{tuple(state.shape)}")
    given = [t for t in (r, k, v, lw, u, state) if t is not None]
    if any(t.dtype != torch.float32 for t in given):
        raise TypeError(f"the WKV kernel takes float32 operands, got "
                        f"{[t.dtype for t in given]}")
    if any(t.device != r.device for t in given):
        raise ValueError("the WKV operands must lie on one device")
    if r.device.type == "cpu":
        return False
    if r.device.type != "cuda":
        raise ValueError(f"no WKV kernel for device {r.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the WKV kernel takes head dims {HEAD_DIMS}, got {d}")
    if b * h > MAX_GRID_Y or s == 0:
        raise ValueError(f"the WKV kernel takes 1 <= S and B*H <= "
                         f"{MAX_GRID_Y}, got {tuple(r.shape)}")
    for st in (u, state):
        if st is not None and not st.is_contiguous():
            raise ValueError("u and the state must be contiguous")
    if any(t.data_ptr() % 16 for t in given):
        raise ValueError("the WKV kernel takes 16-byte aligned operands")
    return True


def _readable(t: torch.Tensor) -> bool:
    """True when the kernel reads a (B,H,S,D) tensor in place: D contiguous
    and the other strides multiples of 4 (16-byte rows)."""
    sb, sh, ss, sd = t.stride()
    return sd == 1 and not (sb % 4 or sh % 4 or ss % 4)


def wkv_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             lw: torch.Tensor, u: torch.Tensor,
             state: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, lw: (B, H, S, D) f32; u: (H, D) f32; state: (B, H, D, D) f32
    or None (zeros). Returns (out (B, H, S, D) f32, final state). A given
    ``state`` is updated in place and returned; without one the final state
    is a new tensor."""
    if not _check(r, k, v, lw, u, state):
        out, final = wkv_ref(r, k, v, lw, u, state)
        return out, final if state is None else state.copy_(final)
    if len({t.stride() for t in (r, k, v, lw)}) != 1 or not _readable(r):
        r, k, v, lw = (t.contiguous() for t in (r, k, v, lw))
    b, h, s, d = r.shape
    # out shares r's layout (dense) or is contiguous, readable either way;
    # in the model's layout the transpose back is free
    out = torch.empty_like(r)
    final = (torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
             if state is None else state)
    _forward(r.get_device(), r.data_ptr(), k.data_ptr(), v.data_ptr(),
             lw.data_ptr(), u.data_ptr(),
             None if state is None else state.data_ptr(), final.data_ptr(),
             out.data_ptr(), b, h, s, d, I64X3(*r.stride()[:3]),
             I64X3(*out.stride()[:3]))
    wkv_cuda.launches += 1
    return out, final


wkv_cuda.launches = 0


def reset_launches() -> None:
    wkv_cuda.launches = 0
