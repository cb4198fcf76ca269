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
launches a kernel or raises; nothing falls back. A fake tensor, on the CPU
or the card (``kernels/_build.py``), gets fake outputs and its launches
recorded (``record_fake``: the kernel's ``cost`` or ``backward_cost``, the
pairs its mask lets through, and ``launch_plan``'s geometry, which mirrors
the source's plan functions), with neither a launch nor the plain version.
The wrappers count every launch in ``flash_attention_cuda.launches`` and
``flash_attention_backward_cuda.launches``, the tensor-core kernels' in
``launches_tc`` of each.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import CapturedLaunch, KernelLibrary, \
    Tile, count_launch, is_fake, record_fake, reset_counts
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                     attention_ref)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 112, 128)
TC_HEAD_DIMS = (64, 112, 128)  # of the tensor-core kernel (bf16 only)
MAX_GRID_Y = 65535  # batch * heads: the scalar kernel's second grid axis
# the backward's per-row stats scratch holds S rows a head padded to a
# multiple of this, the tensor-core dQ kernel's tile
STATS_ROWS = 128
# the source's tiles: the scalar kernels' 64 rows (of 256 threads, a P
# tile of 64 + 4 floats a row), the tensor-core forward's 128 (of three
# warpgroups, a ring of 3 stages of K and V in TMA boxes of 128 rows x 128
# bytes), its backward's 128 rows kept and 64 streamed (two warpgroups)
SCALAR_ROWS, SCALAR_THREADS, PSTR = 64, 256, 64 + 4
TC_ROWS, TC_THREADS, TC_STAGES, BOX = 128, 384, 3, 128 * 128
BWD_SMALL_ROWS, BWD_THREADS = 64, 256


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


def _tc_smem(d: int, backward: bool) -> int:
    """Dynamic shared memory of a tensor-core kernel at head dim ``d``
    (``Smem``/``BwdSmem`` in the source): tiles of D padded to whole 64
    columns, and 1024 bytes of slack to align them."""
    boxes = -(-d // 64)
    if not backward:
        return boxes * BOX * (1 + 2 * TC_STAGES) + 1024
    big, small = boxes * BOX, boxes * BWD_SMALL_ROWS * 128
    return 2 * big + TC_STAGES * 2 * small + TC_STAGES * 64 * 8 + 1024


def launch_plan(b: int, h: int, kh: int, sq: int, sk: int, d: int,
                dtype: torch.dtype, *, lse: bool = False,
                backward: bool = False) -> list[CapturedLaunch]:
    """The launches ``flash_attention_cuda`` (or, with ``backward``,
    ``flash_attention_backward_cuda``, where sq = sk = S) makes over q
    (b, h, sq, d) and k, v (b, kh, sk, d) of ``dtype``, as the source's
    ``forward_plan``, ``prep_plan``, ``dkdv_plan`` and ``dq_plan`` (and
    their ``tc::`` counterparts) make them, on ``kernel_for``'s kernel.
    Query tiles run heavy (late) first, as the kernels order them."""
    tc = kernel_for(dtype, d) == "tensor_core"
    g = h // kh
    code = DTYPES[dtype]
    f32 = torch.float32

    def whole(name, shape, dt):
        return Tile(name, shape, dt, shape, lambda x, y, z: (0,) * len(shape))

    def rows(name, heads, n, tile, at, dt=dtype, written=False, cols=d):
        """A (b, heads, n, cols) operand in tiles of ``tile`` rows, block
        (x, y) at (head, tile) = at(x, y, grid)."""
        shape = (b, heads, n, cols) if cols else (b, heads, n)
        block = (1, 1, tile, cols) if cols else (1, 1, tile)

        def index(x, y, z):
            hh, t = at(x, y)
            return (hh // heads, hh % heads, t) + ((0,) if cols else ())
        return Tile(name, shape, dt, block, index, written=written)

    if not backward:
        if tc:
            gy = -(-sq // TC_ROWS)
            at = (lambda x, y: (x, gy - 1 - y))
            grid, threads, smem, tile = ((b * h, gy, 1), TC_THREADS,
                                         _tc_smem(d, False), TC_ROWS)
            name, which, flag = "flash_fwd_tc", 1, int(lse)
        else:
            gx = -(-sq // SCALAR_ROWS)
            at = (lambda x, y: (y, gx - 1 - x))
            grid, threads, tile = ((gx, b * h, 1), SCALAR_THREADS,
                                   SCALAR_ROWS)
            smem = 4 * (2 * 64 * (d + 4) + SCALAR_ROWS * PSTR)
            name, which, flag = "flash_fwd_kernel", 0, code

        def kv_head(x, y, z):
            hh = at(x, y)[0]
            return (hh // h, hh % h // g, 0, 0)

        ops = [rows("q", h, sq, tile, at),
               Tile("k", (b, kh, sk, d), dtype, (1, 1, sk, d), kv_head),
               Tile("v", (b, kh, sk, d), dtype, (1, 1, sk, d), kv_head),
               rows("o", h, sq, tile, at, written=True)]
        if lse:
            ops.append(rows("lse", h, sq, tile, at, f32, True, cols=0))
        return [CapturedLaunch(name, grid, (threads, 1, 1), smem, True,
                               threads, ops, LIBRARY,
                               (which, b, h, kh, sq, sk, d, flag))]
    s = sq
    sp = -(-s // STATS_ROWS) * STATS_ROWS
    stat_rows = b * h * sp
    prep_blocks = -(-stat_rows * 32 // SCALAR_THREADS)
    warps = SCALAR_THREADS // 32
    prep = CapturedLaunch(
        "flash_bwd_prep", (prep_blocks, 1, 1), (SCALAR_THREADS, 1, 1), 0,
        False, SCALAR_THREADS,
        [whole("o", (b, h, s, d), dtype), whole("do", (b, h, s, d), dtype),
         whole("lse", (b, h, s), f32),
         Tile("stats", (stat_rows * 2,), f32, (2 * warps,),
              lambda x, y, z: (x,), written=True)],
        LIBRARY, (5 if tc else 2, b, h, kh, s, s, d, code))
    stats = whole("stats", (stat_rows * 2,), f32)
    if tc:
        tiles = -(-s // TC_ROWS)
        grid_kv, grid_q = (b * kh, tiles, 1), (b * h, tiles, 1)
        at_kv, at_q = (lambda x, y: (x, y)), (lambda x, y: (x, tiles - 1 - y))
        tile, threads, smem = TC_ROWS, BWD_THREADS, _tc_smem(d, True)
        smem_kv = smem_q = smem
        names, which = ("flash_bwd_dkdv_tc", "flash_bwd_dq_tc"), (6, 7)
    else:
        tiles = -(-s // SCALAR_ROWS)
        grid_kv, grid_q = (tiles, b * kh, 1), (tiles, b * h, 1)
        at_kv, at_q = (lambda x, y: (y, x)), (lambda x, y: (y, tiles - 1 - x))
        tile, threads = SCALAR_ROWS, SCALAR_THREADS
        smem_kv = 4 * (4 * 64 * (d + 4) + 2 * 64 * PSTR + 2 * SCALAR_ROWS)
        smem_q = 4 * (4 * 64 * (d + 4) + SCALAR_ROWS * PSTR
                      + 2 * SCALAR_ROWS)
        names, which = ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"), (3, 4)
    args = (b, h, kh, s, s, d, code)
    dkdv = CapturedLaunch(
        names[0], grid_kv, (threads, 1, 1), smem_kv, True, threads,
        [whole("q", (b, h, s, d), dtype), whole("do", (b, h, s, d), dtype),
         stats, rows("k", kh, s, tile, at_kv), rows("v", kh, s, tile, at_kv),
         rows("dk", kh, s, tile, at_kv, written=True),
         rows("dv", kh, s, tile, at_kv, written=True)],
        LIBRARY, (which[0],) + args)
    dq = CapturedLaunch(
        names[1], grid_q, (threads, 1, 1), smem_q, True, threads,
        [rows("q", h, s, tile, at_q), rows("do", h, s, tile, at_q), stats,
         whole("k", (b, kh, s, d), dtype), whole("v", (b, kh, s, d), dtype),
         rows("dq", h, s, tile, at_q, written=True)],
        LIBRARY, (which[1],) + args)
    return [prep, dkdv, dq]


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
    CUDA tensors, False for CPU tensors and fake ones."""
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
    return _laid_out(q, k, v)


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


def _laid_out(*ops: torch.Tensor) -> bool:
    """Check that the operands are contiguous and 16-byte aligned; False
    where they are fake (their pointers read 0: nothing to align)."""
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("the flash kernel takes contiguous operands")
    try:
        ptrs = [t.data_ptr() for t in ops]
    except RuntimeError:  # a fake tensor's, where reading it raises
        ptrs = [0]
    if any(p % 16 for p in ptrs):
        raise ValueError("the flash kernel takes 16-byte aligned operands")
    return all(ptrs) or not is_fake(ops[0])


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
            kh, sk = k.shape[1], k.shape[2]
            if q.numel():
                record_fake("flash_attention", *cost(
                    b, h, kh, sq, sk, d, q.element_size(), causal, window,
                    q_offset, return_lse), (q, k, v),
                    lambda: launch_plan(b, h, kh, sq, sk, d, q.dtype,
                                        lse=return_lse))
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
            kh = k.shape[1]
            if q.numel():
                record_fake("flash_attention_backward", *backward_cost(
                    b, h, kh, s, d, q.element_size(), causal, window),
                    (q, k, v, o, lse, do),
                    lambda: launch_plan(b, h, kh, s, s, d, q.dtype,
                                        backward=True))
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
