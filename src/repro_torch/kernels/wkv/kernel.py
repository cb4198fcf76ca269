"""Kernel B4: the RWKV6 WKV recurrence as two hand-written CUDA kernels,
and its gradient as a third.

Replaces the JAX package's Pallas TPU kernel (``src/repro/kernels/wkv/
kernel.py`` ``_wkv_kernel`` via ``wkv_pallas``). The source is
``src/repro_torch/csrc/wkv.cu``; its header note gives the bound on an H100
and what each kernel's design does about it. It is built and loaded by
``kernels/_build.py`` without ``--fmad=false``: fused multiply-adds move out
by rounding only (about 1e-7 of max |out| on the card), far below the 1e-5
of max |out| and of max |state| the kernels are held to against
``wkv_ref``.

``kernel_for`` chooses the kernel from the sequence length and the head
dim: head dim 64 with S >= 64 (prefill) takes the chunked tensor-core
kernel (3xTF32 ``mma.sync``), S < 64 (decode) and head dim 16 (the reduced
configs) the sequential one. The choice is made before the launch and never
after a failure; ``kernel=`` forces one (the card tests and
``chip_smoke.py`` hold both to ``wkv_ref`` at the same inputs).

Unlike the Pallas wrapper, this one computes ``wkv_ref``'s function for
every lw <= 0 (the TPU kernel's chunked form overflows under strong decay;
the chunked kernel here forms no exponent), takes any S >= 1 and an
optional initial state, which it updates in place: a decode step carries
its state from step to step without a copy. r, k, v and lw are float32
with any strides whose last is 1 (the model hands over views of its
(B, S, H, D) products); head dims 16 (the reduced config) and 64
(rwkv6-1.6b).

A tensor on the CPU takes the plain PyTorch version in ``ref.py``. A CUDA
tensor launches a kernel or raises; nothing falls back. The wrapper counts
every launch in ``wkv_cuda.launches`` and the tensor-core kernel's in
``wkv_cuda.launches_tc``. A fake tensor, on the CPU or the card
(``kernels/_build.py``), gets fake outputs and its launches recorded
(``record_fake``: the kernel's ``cost`` or ``backward_cost``, and
``launch_plan``'s geometry, which mirrors the source's plan functions),
with neither a launch nor the plain version.

``wkv_backward_cuda`` launches the backward (its plain version is
``wkv_backward_ref``): the gradient of out with no initial state and none
arriving on the final state, which is what training asks of it
(``ops.WkvFn``). ``kernel_for``'s rule picks its kernel too: head dim 64
with S >= 64 (training) takes the chunked tensor-core backward
(``wkv_backward_tc`` in the source: a carry kernel for the state entering
each chunk and the gradient leaving it, then one block a chunk; the plain
version of its arithmetic is ``wkv_chunked_backward_ref``), the rest the
sequential one (``wkv_backward``); ``kernel=`` forces one. It counts every
launch in ``wkv_backward_cuda.launches`` and the chunked backward's in
``wkv_backward_cuda.launches_tc``.

The launch path is short, since a decode step calls it 24 times
(``chip_smoke.py``'s ``wkv_host_path`` phase times each step of it on the
card): the checks read ``is_cuda`` and ``get_device()`` rather than
``torch.device`` objects, and the fifteen arguments go to the kernel packed
into one buffer by ``struct`` (``WkvArgs`` in the source), which ctypes
passes as one pointer. A fake tensor leaves it where its pointers read 0,
inside the alignment test.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Optional

import torch

from repro_torch.kernels._build import CapturedLaunch, KernelLibrary, \
    Tile, count_launch, fake_on_card, is_fake, record_fake, reset_counts
from repro_torch.kernels.wkv.ref import CHUNK, wkv_backward_ref, wkv_ref

HEAD_DIMS = (16, 64)
TC_HEAD_DIM = 64  # head dim of the chunked tensor-core kernel
KERNELS = ("sequential", "tensor_core")
MAX_GRID_Y = 65535  # batch * heads: the grid's second axis
# WkvArgs in wkv.cu: r, k, v, lw, u, state_in (0: zeros), state_out, out;
# B, H, S, D; the strides (b, h, s) of r, k, v, lw, then of out; in native
# byte order without padding
_pack = struct.Struct("=8Q4i6q").pack
# the source's launch shapes: the sequential forward's (SPLIT, COLS) a
# head dim (wkv_forward's instances: COLS value columns a block, COLS *
# SPLIT threads), the sequential backward's (NR, WARPS) (wkv_backward's),
# and the chunked kernels' value columns a block (NJ), threads, and row
# stride of their shared tiles (LDR, floats)
SEQ = {16: (4, 16), 64: (8, 16)}
BACK = {16: (2, 4), 64: (4, 8)}
NJ, TC_THREADS, LDR = 32, 256, TC_HEAD_DIM + 4
SEGMENT = 16  # tokens a segment of the sequential backward


def cost(b: int, h: int, s: int, d: int, state: bool) -> tuple[int, int]:
    """(flops, bytes) of the forward: r, k, v, lw read once, out written
    once, u read once, the initial state (if any) read once and the final
    one written once, all f32; 5 D^2 operations a step of one head (D^2
    fused multiply-adds for r_t . S_{t-1}, D^2 multiplies and D^2 fused
    multiply-adds for exp(lw) S + k v) and 5 D for the bonus term v_t (r_t
    . diag(u) k_t) and its add."""
    nbytes = 4 * (5 * b * h * s * d + h * d + (2 if state else 1)
                  * b * h * d * d)
    return 5 * d * (d + 1) * b * h * s, nbytes


def backward_cost(b: int, h: int, s: int, d: int) -> tuple[int, int]:
    """(flops, bytes) of the gradient: r, k, v, lw, dout read once, dr, dk,
    dv, dlw written once, u read and du written once, all f32; the
    operations the gradient needs, 14 D^2 a token of one head (the state
    S_{t-1} formed once, 3 D^2: a multiply and a fused multiply-add an
    element; the reverse step's fused multiply-adds for dr, dk, dlw, dv and
    G's decay, and r dout^T, 11 D^2) and ~13 D for the bonus terms, v .
    dout, r . diag(u) k and du. The kernels form the state twice (the
    sequential one saves a state every 16 tokens and replays each segment;
    the chunked one carries each chunk's state first): that second pass is
    their design's cost, not the function's."""
    nbytes = 4 * (9 * b * h * s * d + 2 * h * d)
    return (14 * d * d + 13 * d) * b * h * s, nbytes


def _back_layout(d: int) -> tuple[int, int, int, int]:
    """(rows a block R, blocks a head, threads, shared bytes) of the
    sequential backward at head dim ``d`` (``back::Layout``)."""
    nr, warps = BACK[d]
    lanes = min(d, 32)
    rows = warps * (32 // lanes) * nr
    threads = 32 * warps
    hist = SEGMENT * nr * (d // lanes) * threads
    floats = (hist + 6 * SEGMENT * rows + 2 * SEGMENT * d + 2 * SEGMENT
              + SEGMENT * warps * d)
    return rows, d // rows, threads, 4 * floats


def _tc_smem(which: str) -> int:
    """Dynamic shared memory of a chunked kernel (``chunk::Smem``,
    ``cback::CarrySmem``, ``cback::BackSmem`` in the source), and the 128
    bytes of slack to align it."""
    c, d = CHUNK, TC_HEAD_DIM
    nq, nkf, ldq = c // 8, 12, NJ + 2
    if which == "forward":
        floats = (4 * c * LDR + 2 * c * NJ + 2 * c * LDR + 4 * 8 * 32
                  + 3 * nq * d + nkf * d + d)
        return 4 * floats + 16 * (c // 8 + d // 8) * 4 * ldq + 16 + 128
    if which == "carry":
        return 4 * (9 * c * LDR + 5 * d) + 128
    return 4 * (11 * c * LDR + 3 * nq * d + 2 * nkf * d + 2 * d + c
                + 12 * d) + 128


def launch_plan(b: int, h: int, s: int, d: int, *, kernel: str,
                state: bool = False, backward: bool = False
                ) -> list[CapturedLaunch]:
    """The launches ``wkv_cuda`` (``state``: given one, which it updates in
    place) or, with ``backward``, ``wkv_backward_cuda`` makes over (b, h,
    s, d) on ``kernel``, as the source's ``forward_plan``,
    ``chunk_forward_plan``, ``back::plan``, ``cback::carry_plan`` and
    ``cback::chunk_plan`` make them."""
    f32 = torch.float32
    bhsd = (b, h, s, d)

    def per_head(name, block, at, written=False, shape=bhsd, alias=None):
        """An operand of ``shape`` whose tile ``block`` the block at (x, y)
        takes at (b, h) = divmod(y, h) and the rest ``at(x)``."""
        return Tile(name, shape, f32, block,
                    lambda x, y, z: divmod(y, h) + at(x), written, alias)

    def head(name):
        return per_head(name, (1, 1, s, d), lambda x: (0, 0))

    u = Tile("u", (h, d), f32, (1, d), lambda x, y, z: (y % h, 0))
    if not backward:
        cols, threads = (NJ, TC_THREADS) if kernel == "tensor_core" else (
            SEQ[d][1], SEQ[d][0] * SEQ[d][1])
        ops = [head("r"), head("k"), head("lw"), u,
               per_head("v", (1, 1, s, cols), lambda x: (0, x)),
               per_head("out", (1, 1, s, cols), lambda x: (0, x), True)]
        square = (b, h, d, d)
        if state:
            ops.append(per_head("state", (1, 1, d, cols), lambda x: (0, x),
                                shape=square))
        ops.append(per_head("final", (1, 1, d, cols), lambda x: (0, x), True,
                            square, "state" if state else None))
        grid = (d // cols, b * h, 1)
        if kernel == "tensor_core":
            return [CapturedLaunch("wkv_chunk_kernel", grid, (threads, 1, 1),
                                   _tc_smem("forward"), True, threads, ops,
                                   LIBRARY, (1, b, h, s, d, 0, 0, 0))]
        return [CapturedLaunch("wkv_kernel", grid, (threads, 1, 1), 0, False,
                               threads, ops, LIBRARY,
                               (0, b, h, s, d, 0, 0, 0))]
    if kernel == "tensor_core":
        nc = -(-s // CHUNK)
        states = (2, b * h, nc, d * d)
        carry = CapturedLaunch(
            "wkv_carry_kernel", (b * h, 2, 1), (TC_THREADS, 1, 1),
            _tc_smem("carry"), True, TC_THREADS,
            [head("r"), head("k"), head("v"), head("lw"), head("dout"),
             Tile("states", states, f32, (1, 1, nc, d * d),
                  lambda x, y, z: (y, x, 0, 0), written=True)],
            LIBRARY, (3, b, h, s, d, 0, 0, 0))

        def chunk(name, written=False, shape=bhsd, block=(1, 1, CHUNK, d)):
            return Tile(name, shape, f32, block,
                        lambda x, y, z: divmod(y, h) + (x, 0), written)

        chunks = CapturedLaunch(
            "wkv_chunk_backward_kernel", (nc, b * h, 1), (TC_THREADS, 1, 1),
            _tc_smem("backward"), True, TC_THREADS,
            [Tile("states", states, f32, states,
                  lambda x, y, z: (0, 0, 0, 0)), u]
            + [chunk(n) for n in ("r", "k", "v", "lw", "dout")]
            + [chunk(n, True) for n in ("dr", "dk", "dv", "dlw")]
            + [chunk("du", True, (b, h, nc, d), (1, 1, 1, d))],
            LIBRARY, (4, b, h, s, d, 0, 0, 0))
        return [carry, chunks]
    rows, groups, threads, smem = _back_layout(d)
    mine = (lambda x: (0, x))  # the block's rows of a head
    return [CapturedLaunch(
        "wkv_backward_kernel", (groups, b * h, 1), (threads, 1, 1), smem,
        True, threads,
        [per_head(n, (1, 1, s, rows), mine) for n in ("r", "k", "lw")]
        + [head("v"), head("dout"), u]
        + [per_head(n, (1, 1, s, rows), mine, True)
           for n in ("dr", "dk", "dlw")]
        + [Tile("dv", (groups, b, h, s, d), f32, (1, 1, 1, s, d),
                lambda x, y, z: (x,) + divmod(y, h) + (0, 0), True),
           per_head("du", (1, 1, rows), lambda x: (x,), True, (b, h, d))],
        LIBRARY, (2, b, h, s, d, 0, 0, 0))]


def _record(r, k, v, lw, u, state, kernel) -> None:
    """The forward's launch on fake tensors, recorded."""
    b, h, s, d = r.shape
    kernel = kernel or kernel_for(s, d)
    ops = (r, k, v, lw, u) + (() if state is None else (state,))
    record_fake("wkv", *cost(b, h, s, d, state is not None), ops,
                lambda: launch_plan(b, h, s, d, kernel=kernel,
                                    state=state is not None))


def kernel_for(s: int, head_dim: int) -> str:
    """The kernel that takes a CUDA call, forward or backward:
    ``"tensor_core"`` for head dim 64 and at least one chunk of tokens,
    ``"sequential"`` for the rest (decode steps and the reduced configs'
    head dim 16)."""
    if head_dim == TC_HEAD_DIM and s >= CHUNK:
        return "tensor_core"
    return "sequential"


def _declare(lib: ctypes.CDLL) -> None:
    for name in ("wkv_forward", "wkv_forward_tc", "wkv_backward",
                 "wkv_backward_tc"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.wkv_backward_layout.argtypes = [ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)]
    lib.wkv_backward_layout.restype = ctypes.c_int


LIBRARY = KernelLibrary("wkv", "wkv.cu", declare=_declare)
load_library = LIBRARY.load
_LAUNCH = {"sequential": LIBRARY.launcher("wkv_forward"),
           "tensor_core": LIBRARY.launcher("wkv_forward_tc")}
_LAUNCH_BACKWARD = {"sequential": LIBRARY.launcher("wkv_backward"),
                    "tensor_core": LIBRARY.launcher("wkv_backward_tc")}
# WkvBackArgs in wkv.cu: r, k, v, lw, u, dout, dr, dk, dv, dlw, du, the
# scratch (saved states); B, H, S, D; the strides (b, h, s) of r, k, v, lw
_pack_backward = struct.Struct("=12Q4i3q").pack


def _on_card(r, k, v, lw, u, state) -> int:
    """Check the operands (all but their alignment and strides, which the
    wrapper checks on what it passes); return the CUDA device index for
    tensors on the card, -1 for tensors on the CPU.

    Written out rather than looped over the operands: a decode step takes
    this path 24 times, and generators over six tensors cost it twice as
    much (``chip_smoke.py``'s ``wkv_host_path`` times it on the card)."""
    shape = r.shape
    if len(shape) != 4 or k.shape != shape or v.shape != shape \
            or lw.shape != shape:
        raise ValueError(f"r, k, v, lw must be (B,H,S,D) of one shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, lw)]}")
    b, h, s, d = shape
    if u.shape != (h, d):
        raise ValueError(f"u must be (H, D) = {(h, d)}, got {tuple(u.shape)}")
    given_state = state is not None
    if given_state and state.shape != (b, h, d, d):
        raise ValueError(f"state must be (B,H,D,D) = {(b, h, d, d)}, got "
                         f"{tuple(state.shape)}")
    f32 = torch.float32
    if r.dtype is not f32 or k.dtype is not f32 or v.dtype is not f32 \
            or lw.dtype is not f32 or u.dtype is not f32 \
            or (given_state and state.dtype is not f32):
        dtypes = [t.dtype for t in (r, k, v, lw, u, state) if t is not None]
        raise TypeError(f"the WKV kernel takes float32 operands, got "
                        f"{dtypes}")
    if not r.is_cuda:
        if any(t is not None and t.device != r.device
               for t in (k, v, lw, u, state)):
            raise ValueError("the WKV operands must lie on one device")
        if r.device.type == "cpu":
            return -1
        raise ValueError(f"no WKV kernel for device {r.device}")
    device = r.get_device()  # -1 off the card
    if k.get_device() != device or v.get_device() != device \
            or lw.get_device() != device or u.get_device() != device \
            or (given_state and state.get_device() != device):
        raise ValueError("the WKV operands must lie on one device")
    if d not in HEAD_DIMS:
        raise ValueError(f"the WKV kernel takes head dims {HEAD_DIMS}, "
                         f"got {d}")
    if b * h > MAX_GRID_Y or s == 0:
        raise ValueError(f"the WKV kernel takes 1 <= S and B*H <= "
                         f"{MAX_GRID_Y}, got {tuple(shape)}")
    if not u.is_contiguous() or (given_state and not state.is_contiguous()):
        raise ValueError("u and the state must be contiguous")
    return device


def _readable(strides: tuple[int, ...]) -> bool:
    """True when the kernels read a (B,H,S,D) tensor of these strides in
    place: D contiguous and the other strides multiples of 4 (16-byte
    rows)."""
    sb, sh, ss, sd = strides
    return sd == 1 and not (sb % 4 or sh % 4 or ss % 4)


def wkv_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             lw: torch.Tensor, u: torch.Tensor,
             state: Optional[torch.Tensor] = None, *,
             kernel: Optional[str] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, lw: (B, H, S, D) f32; u: (H, D) f32; state: (B, H, D, D) f32
    or None (zeros). Returns (out (B, H, S, D) f32, final state). A given
    ``state`` is updated in place and returned; without one the final state
    is a new tensor. ``kernel`` ("sequential" or "tensor_core", the latter
    at head dim 64 only) forces a kernel for CUDA tensors; None takes
    ``kernel_for``'s."""
    if kernel is not None and kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    device = _on_card(r, k, v, lw, u, state)
    if device < 0:
        if is_fake(r):
            b, h, s, d = r.shape
            _record(r, k, v, lw, u, state, kernel)
            return torch.empty_like(r), (
                state if state is not None else torch.empty(
                    (b, h, d, d), dtype=torch.float32, device=r.device))
        out, final = wkv_ref(r, k, v, lw, u, state)
        return out, final if state is None else state.copy_(final)
    b, h, s, d = r.shape
    if kernel is None:
        kernel = kernel_for(s, d)
    elif kernel == "tensor_core" and d != TC_HEAD_DIM:
        raise ValueError(f"the tensor-core WKV kernel takes head dim "
                         f"{TC_HEAD_DIM}, got {d}")
    strides = r.stride()
    if k.stride() != strides or v.stride() != strides \
            or lw.stride() != strides or not _readable(strides):
        r, k, v, lw = (t.contiguous() for t in (r, k, v, lw))
        strides = r.stride()
    # out shares r's layout (dense) or is contiguous, readable either way;
    # in the model's layout the transpose back is free
    out = torch.empty_like(r)
    final = (torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
             if state is None else state)
    try:
        pr, pk, pv, pl, pu = (r.data_ptr(), k.data_ptr(), v.data_ptr(),
                              lw.data_ptr(), u.data_ptr())
        pf, po = final.data_ptr(), out.data_ptr()
    except RuntimeError:  # a fake tensor's, where reading it raises
        pr = pk = pv = pl = pu = pf = po = 0
    if (pr | pk | pv | pl | pu | pf | po) % 16 or not pr:
        if is_fake(r):
            _record(r, k, v, lw, u, state, kernel)
            return out, final
        if (pr | pk | pv | pl | pu | pf | po) % 16:
            raise ValueError("the WKV kernel takes 16-byte aligned operands")
    _LAUNCH[kernel](device, _pack(pr, pk, pv, pl, pu,
                                  0 if state is None else pf, pf, po, b, h,
                                  s, d, *strides[:3], *out.stride()[:3]))
    if kernel == "tensor_core":
        count_launch(wkv_cuda, "launches", "launches_tc")
    else:
        count_launch(wkv_cuda)
    return out, final


wkv_cuda.launches = 0
wkv_cuda.launches_tc = 0


def backward_layout(d: int) -> tuple[int, int]:
    """(blocks of rows a head, tokens a segment) of the backward kernel at
    head dim ``d``, as the source defines them."""
    out = (ctypes.c_int * 2)()
    LIBRARY.check(LIBRARY.load().wkv_backward_layout(d, out),
                  "wkv_backward_layout")
    return out[0], out[1]


def wkv_backward_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lw: torch.Tensor, u: torch.Tensor, dout: torch.Tensor,
                      *, kernel: Optional[str] = None
                      ) -> tuple[torch.Tensor, ...]:
    """The gradient of ``wkv_cuda``'s out with no initial state, for the
    cotangent ``dout`` (B, H, S, D) of out and none on the final state:
    (dr, dk, dv, dlw (B, H, S, D), du (H, D)), f32. CUDA tensors launch the
    kernel ``kernel_for`` picks (or ``kernel``: "sequential", head dims 16
    and 64, or "tensor_core", head dim 64; any S >= 1); CPU tensors take
    ``wkv_backward_ref``. Deterministic: the partial sums of dv (sequential:
    over the blocks of rows of a head) and of du (over the batch, and the
    chunks) are added here, in order."""
    if kernel is not None and kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    device = _on_card(r, k, v, lw, u, None)
    if dout.shape != r.shape:
        raise ValueError(f"dout must be {tuple(r.shape)}, got "
                         f"{tuple(dout.shape)}")
    if dout.dtype is not torch.float32:
        raise TypeError(f"dout must be float32, got {dout.dtype}")
    if device < 0:
        if dout.device != r.device:
            raise ValueError("the WKV operands must lie on one device")
        if is_fake(r):
            return _fake_backward(r, k, v, lw, u, dout, kernel)
        return wkv_backward_ref(r, k, v, lw, u, dout)
    if dout.get_device() != device:
        raise ValueError("the WKV operands must lie on one device")
    b, h, s, d = r.shape
    if kernel is None:
        kernel = kernel_for(s, d)
    elif kernel == "tensor_core" and d != TC_HEAD_DIM:
        raise ValueError(f"the tensor-core WKV backward takes head dim "
                         f"{TC_HEAD_DIM}, got {d}")
    if fake_on_card(r):
        return _fake_backward(r, k, v, lw, u, dout, kernel)
    strides = r.stride()
    if k.stride() != strides or v.stride() != strides \
            or lw.stride() != strides or not _readable(strides):
        r, k, v, lw = (t.contiguous() for t in (r, k, v, lw))
        strides = r.stride()
    dout = dout.contiguous()
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dlw = (torch.empty((b, h, s, d), **f32) for _ in range(3))
    if kernel == "tensor_core":
        chunks = -(-s // CHUNK)
        dv = torch.empty((b, h, s, d), **f32)
        du = torch.empty((b, h, chunks, d), **f32)
        scratch = torch.empty((2 * b * h * chunks * d * d,), **f32)
    else:
        groups, seg = backward_layout(d)
        dv = torch.empty((groups, b, h, s, d), **f32)
        du = torch.empty((b, h, d), **f32)
        scratch = torch.empty((b * h * (-(-s // seg)) * d * d,), **f32)
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), dout.data_ptr(), dr.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dlw.data_ptr(), du.data_ptr(), scratch.data_ptr())
    if any(p % 16 for p in ptrs):
        raise ValueError("the WKV kernel takes 16-byte aligned operands")
    _LAUNCH_BACKWARD[kernel](device, _pack_backward(*ptrs, b, h, s, d,
                                                    *strides[:3]))
    if kernel == "tensor_core":
        count_launch(wkv_backward_cuda, "launches", "launches_tc")
        return dr, dk, dv, dlw, du.sum((0, 2))
    count_launch(wkv_backward_cuda)
    return dr, dk, dv[0] if dv.shape[0] == 1 else dv.sum(0), dlw, du.sum(0)


wkv_backward_cuda.launches = 0
wkv_backward_cuda.launches_tc = 0


def _fake_backward(r, k, v, lw, u, dout, kernel):
    """The backward on fake tensors: its launches recorded, fake
    gradients."""
    b, h, s, d = r.shape
    kernel = kernel or kernel_for(s, d)
    record_fake("wkv_backward", *backward_cost(b, h, s, d),
                (r, k, v, lw, u, dout),
                lambda: launch_plan(b, h, s, d, kernel=kernel, backward=True))
    f32 = dict(dtype=torch.float32, device=r.device)
    return tuple(torch.empty((b, h, s, d), **f32)
                 for _ in range(4)) + (torch.empty((h, d), **f32),)


def reset_launches() -> None:
    reset_counts(wkv_cuda, "launches", "launches_tc")
    reset_counts(wkv_backward_cuda, "launches", "launches_tc")
