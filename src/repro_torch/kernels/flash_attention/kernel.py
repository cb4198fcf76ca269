"""Kernel B3: the flash-attention forward as two hand-written CUDA kernels,
and its backward as two more.

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

``flash_attention_cuda(..., q_offset=r)`` takes q (B, H, Sq, D) as the
rows ``[r, r + Sq)`` of a sequence whose Sk keys k and v (B, K, Sk, D)
hold (a model rank's query rows under prefill's ``seq_inner``, against the
sequence's all-gathered K/V): the causal mask keeps keys ``j <= r + i``
for query row i and the window keys ``j > r + i - window``; a masked call
needs ``r + Sq <= Sk``, an unmasked one takes any Sq and Sk. The forward
alone: the backward takes one length and refuses an offset.

``flash_attention_cuda(..., return_lse=True)`` also returns each row's
log-sum-exp (B, H, Sq) in f32, in the log2 domain (log2 of the softmax's
denominator with the row's max folded in), which the backward recomputes
the probabilities from; without it the kernels write nothing more.

``flash_attention_backward_cuda`` is the gradient: from q, k, v, the
forward's o and lse and the cotangent of o, (dq, dk, dv) in q's dtype. The
same rule picks its kernel: bfloat16 at head dims 64, 112 and 128 takes the
tensor-core backward (wgmma, TMA: a dK/dV kernel over key tiles and a dQ
kernel over query tiles, deterministic, no atomics), the rest the scalar
f32 backward. Its plain version is ``ops.flash_attention_backward`` given
``o`` and ``lse``.

A tensor on the CPU takes the plain PyTorch version. A CUDA tensor
launches a kernel or raises; nothing falls back. A fake tensor (the dry
run's, ``kernels/_build.py``) gets fake outputs and the kernel's ``cost``
(or ``backward_cost``) counted, the pairs its mask lets through, with
neither a launch nor the plain version. The wrappers count every
launch in ``flash_attention_cuda.launches`` and
``flash_attention_backward_cuda.launches``, the tensor-core kernels' in
``launches_tc`` of each.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import KernelLibrary, count_fake, \
    count_launch, is_fake, reset_counts
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                     attention_ref)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 112, 128)
TC_HEAD_DIMS = (64, 112, 128)  # of the tensor-core kernel (bf16 only)
MAX_GRID_Y = 65535  # batch * heads: the scalar kernel's second grid axis
# the backward's per-row stats scratch holds S rows a head padded to a
# multiple of this, the tensor-core dQ kernel's tile
STATS_ROWS = 128


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes a CUDA call: ``"tensor_core"`` for bfloat16 at
    head dims 64, 112 and 128, ``"scalar"`` for the rest. f32 stays off the
    tensor cores, whose f32 product would be TF32."""
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return "tensor_core"
    return "scalar"


def attention_pairs(sq: int, causal: bool, window: int, q_offset: int = 0,
                    sk: Optional[int] = None) -> int:
    """(q, k) pairs the mask lets through in one head: query row i at
    position ``q_offset + i`` of a sequence of ``sk`` keys (None: ``sq``)
    sees keys j <= q_offset + i (and j > q_offset + i - window with a
    window) when causal, all ``sk`` keys when not."""
    sk = sq if sk is None else sk
    if not causal:
        return sq * sk

    def upto(n: int) -> int:  # the pairs of positions 0 .. n-1
        if not window or n <= window:
            return n * (n + 1) // 2
        return window * (window + 1) // 2 + (n - window) * window

    return upto(q_offset + sq) - upto(q_offset)


def cost(b: int, h: int, kh: int, sq: int, sk: int, d: int,
         dtype_bytes: int, causal: bool = True, window: int = 0,
         q_offset: int = 0, lse: bool = False) -> tuple[int, int]:
    """(flops, bytes) of the forward over q (B, H, Sq, D) at ``q_offset``
    against k, v (B, K, Sk, D): QK^T and PV over the pairs the mask lets
    through (``attention_pairs``, 4*D operations a pair); q read and o
    written once (H heads of Sq rows), and of k and v (K heads) the rows
    any query sees, ``q_offset + Sq`` of them when causal, all Sk when
    not; with ``lse`` each row's f32 log-sum-exp written once."""
    window = window if causal else 0
    flops = 4 * d * attention_pairs(sq, causal, window, q_offset, sk) * b * h
    kv_rows = min(sk, q_offset + sq) if causal else sk
    nbytes = dtype_bytes * b * d * (2 * h * sq + 2 * kh * kv_rows)
    return flops, nbytes + (4 * b * h * sq if lse else 0)


def backward_cost(b: int, h: int, kh: int, s: int, d: int, dtype_bytes: int,
                  causal: bool = True, window: int = 0) -> tuple[int, int]:
    """(flops, bytes) of the gradient: its four products over the pairs
    the mask lets through, dV = P^T dO, dP = dO V^T, dQ = dS K and dK =
    dS^T Q (8*D operations a pair, twice the forward's); q, o, do, dq (H
    heads) and k, v, dk, dv (K heads) read or written once, lse read once.
    The kernels' recompute of S = Q K^T (once in each of their two
    kernels) and of dP in the dQ kernel is their design's cost, not the
    function's."""
    window = window if causal else 0
    flops = 8 * d * attention_pairs(s, causal, window) * b * h
    nbytes = dtype_bytes * b * s * d * (4 * h + 4 * kh) + 4 * b * h * s
    return flops, nbytes


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_forward.argtypes = [ptr] * 5 + [i32] * 7 + [
        f32, i32, i32, i32, ptr]
    lib.flash_attention_forward_tc.argtypes = [ptr] * 5 + [i32] * 7 + [
        f32, i32, i32, ptr]
    lib.flash_attention_backward.argtypes = [ptr] * 10 + [i32] * 6 + [
        f32, i32, i32, i32, ptr]
    lib.flash_attention_backward_tc.argtypes = [ptr] * 10 + [i32] * 6 + [
        f32, i32, i32, ptr]
    for name in ("flash_attention_forward", "flash_attention_forward_tc",
                 "flash_attention_backward", "flash_attention_backward_tc"):
        getattr(lib, name).restype = i32


LIBRARY = KernelLibrary("flash", "flash_attention.cu", declare=_declare)
load_library = LIBRARY.load
_scalar = LIBRARY.launcher("flash_attention_forward")
_tensor_core = LIBRARY.launcher("flash_attention_forward_tc")
_scalar_backward = LIBRARY.launcher("flash_attention_backward")
_tensor_core_backward = LIBRARY.launcher("flash_attention_backward_tc")


def _on_card(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Check the operands (their lengths apart: ``_lengths``); True for
    CUDA tensors, False for CPU tensors."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B,H,Sq,D) and k, v (B,K,Sk,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    kh = k.shape[1]
    if (k.shape[0], k.shape[3]) != (b, d) or kh == 0 or h % kh:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}: same B, D and K dividing H")
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
    _laid_out(q, k, v)
    return True


def _lengths(q: torch.Tensor, k: torch.Tensor, causal: bool,
             q_offset: int) -> None:
    """A masked call's queries must lie inside the keys' sequence: q's Sq
    rows at ``q_offset`` end at or before Sk; an unmasked call takes any
    Sq and Sk."""
    sq, sk = q.shape[2], k.shape[2]
    if q_offset < 0 or (causal and q_offset + sq > sk):
        raise ValueError(f"q of {sq} rows at offset {q_offset} do not lie "
                         f"in k, v of {sk}: a masked call takes q_offset + "
                         f"Sq <= Sk")


def _laid_out(*ops: torch.Tensor) -> None:
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("the flash kernel takes contiguous operands")
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError("the flash kernel takes 16-byte aligned operands")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         scale: Optional[float] = None,
                         return_lse: bool = False, q_offset: int = 0):
    """Attention forward over q (B,H,Sq,D) and k, v (B,K,Sk,D): causal with
    an optional sliding window (k > q - window), or full, query row i at
    position ``q_offset + i`` of the keys' sequence; scale D^-1/2 unless
    given; output in q's dtype. With ``return_lse``, (output, lse): lse
    (B,H,Sq) f32, each row's log-sum-exp of its masked, scaled logits in
    the log2 domain."""
    on_card = _on_card(q, k, v)
    q_offset = int(q_offset)
    _lengths(q, k, causal, q_offset)
    if not on_card:
        if is_fake(q):
            b, h, sq, d = q.shape
            if q.numel():
                count_fake("flash_attention", *cost(
                    b, h, k.shape[1], sq, k.shape[2], d, q.element_size(),
                    causal, window, q_offset, return_lse))
            out = torch.empty_like(q)
            if not return_lse:
                return out
            return out, torch.empty((b, h, sq), dtype=torch.float32,
                                    device=q.device)
        out = attention_ref(q, k, v, causal=causal, window=window,
                            scale=scale, q_offset=q_offset)
        if not return_lse:
            return out
        return out, attention_lse_ref(q, k, causal=causal, window=window,
                                      scale=scale, q_offset=q_offset)
    b, h, s, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel() > 0:
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), b, h, k.shape[1],
                s, k.shape[2], q_offset, d, scale, int(causal), int(window))
        if kernel_for(q.dtype, d) == "tensor_core":
            _tensor_core(q.get_device(), *args)
            count_launch(flash_attention_cuda, "launches", "launches_tc")
        else:
            _scalar(q.get_device(), *args, DTYPES[q.dtype])
            count_launch(flash_attention_cuda)
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_tc = 0


def flash_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor, *,
                                  causal: bool = True, window: int = 0,
                                  q_offset: int = 0
                                  ) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of o = attention(q, k, v) for the cotangent ``do``,
    from the forward's output ``o`` and ``lse`` (``return_lse``): q, o, do
    (B,H,S,D) and k, v (B,K,S,D) of one dtype, lse (B,H,S) f32; scale
    D^-1/2. The gradients come in q's dtype. One length: q of another
    length than k and v, or a ``q_offset``, raises."""
    on_card = _on_card(q, k, v)
    if q_offset or q.shape[2] != k.shape[2]:
        raise ValueError(f"the flash backward takes q, k and v of one "
                         f"length at offset 0, got q of {q.shape[2]} rows "
                         f"at offset {q_offset} and k, v of {k.shape[2]}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must be {tuple(q.shape)}, got "
                         f"{tuple(o.shape)}, {tuple(do.shape)}")
    if lse.shape != q.shape[:3]:
        raise ValueError(f"lse must be {tuple(q.shape[:3])}, got "
                         f"{tuple(lse.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype \
            or lse.dtype != torch.float32:
        raise TypeError(f"o and do must be {q.dtype} and lse float32, got "
                        f"{o.dtype}, {do.dtype}, {lse.dtype}")
    if any(t.device != q.device for t in (o, lse, do)):
        raise ValueError("the flash backward's operands must lie on one "
                         "device")
    if not causal:
        window = 0
    if not on_card:
        if is_fake(q):
            b, h, s, d = q.shape
            if q.numel():
                count_fake("flash_attention_backward", *backward_cost(
                    b, h, k.shape[1], s, d, q.element_size(), causal,
                    window))
            return tuple(torch.empty_like(t) for t in (q, k, v))
        from repro_torch.kernels.flash_attention.ops import \
            flash_attention_backward
        return flash_attention_backward(q, k, v, do, o=o, lse=lse,
                                        causal=causal, window=window)
    _laid_out(o, lse, do)
    b, h, s, d = q.shape
    kh = k.shape[1]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    sp = -(-s // STATS_ROWS) * STATS_ROWS
    stats = torch.empty((b * h * sp * 2,), dtype=torch.float32,
                        device=q.device)
    args = tuple(t.data_ptr() for t in (q, k, v, o, lse, do, dq, dk, dv,
                                        stats)) + (
        b, h, kh, s, sp, d, d ** -0.5, int(causal), int(window))
    if kernel_for(q.dtype, d) == "tensor_core":
        _tensor_core_backward(q.get_device(), *args)
        count_launch(flash_attention_backward_cuda, "launches", "launches_tc")
    else:
        _scalar_backward(q.get_device(), *args, DTYPES[q.dtype])
        count_launch(flash_attention_backward_cuda)
    return dq, dk, dv


flash_attention_backward_cuda.launches = 0
flash_attention_backward_cuda.launches_tc = 0


def reset_launches() -> None:
    reset_counts(flash_attention_cuda, "launches", "launches_tc")
    reset_counts(flash_attention_backward_cuda, "launches", "launches_tc")
