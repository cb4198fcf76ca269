"""Static lint for the port's CUDA launches (grid x block x tile geometry).

Counterpart of the JAX package's ``analysis/kernel_lint.py``. A
``pallas_call`` states its data movement in its grid and BlockSpecs; a
CUDA launch states it in its grid, its block, its dynamic shared memory,
and the tiles each block reads and writes, which each kernel module's
``launch_plan`` spells out as its source's host code computes them (the
source exports the same geometry as ``<prefix>_plan``, from the function
its launcher launches by). The classic kernel bugs (a grid of nothing, a
block past the kernel's ``__launch_bounds__``, a tile read past an
operand's end, output elements no block writes, shared memory over the
card's limit or above 48 KB without the opt-in) are all checkable without
running the kernel. :func:`capture_launches` records every launch the real
wrappers make on fake tensors (``kernels/_build.py``: the wrappers run
their checks and allocate their outputs, and launch nothing), then
:func:`lint_captured` replays every tile map over the grid.

Rules (IDs ``<rule>:<site>``; the reference's rule on the left where it
differs):

* ``empty-grid`` (error) — a grid dimension ≤ 0, or y or z over 65,535:
  the kernel never runs, or does not launch.
* ``block-shape`` (error; ``index-arity``) — a block of more than 1,024
  threads, or more than the kernel's ``__launch_bounds__``.
* ``oob-block`` (error) — some block's tile starts past its operand (reads
  garbage / faults; a tile that merely runs over the end is the masked
  edge every kernel here handles).
* ``uncovered-output`` (error) — the blocks' tiles leave output elements
  unwritten.
* ``smem-opt-in`` (warn; ``unspecified-memory-space``) — dynamic shared
  memory over 48 KB without ``cudaFuncSetAttribute`` (the launch fails).
* ``smem-overflow`` (warn; ``vmem-overflow``) — shared memory over the
  budget: an H100's 227 KB a block.
* ``ref-alias`` (info/error) — an operand written in place; shapes or
  dtypes that differ are an error.

On the card, :func:`lint_on_card` adds what only the card knows (the
library's ``<prefix>_attributes``):

* ``no-occupancy`` (error) — 0 blocks an SM at the launch's geometry;
* ``register-spill`` (warn) — local memory a thread above 0.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.offload_lint import Finding, _sorted
from repro_torch.kernels._build import (CapturedLaunch, Tile,
                                        attributes_on_card, capturing,
                                        plan_on_card)

# Shared memory a block may hold on an H100 (227 KB,
# cudaDevAttrMaxSharedMemoryPerBlockOptin) and the most without opting in.
H100_SMEM_BUDGET = 232_448
SMEM_DEFAULT = 48 * 1024
MAX_THREADS = 1024
MAX_GRID_YZ = 65535
MAX_GRID_X = 2 ** 31 - 1
# Replaying every tile map over every block is exact but O(|grid|); past
# this we fall back to the corner blocks and skip coverage.
_MAX_GRID_POINTS = 1 << 18
_MAX_COVER_CELLS = 1 << 22

__all__ = ["CARD_CASES", "CapturedLaunch", "KERNEL_FAMILIES", "Tile",
           "capture_family", "capture_launches", "lint_captured",
           "lint_card_cases", "lint_kernel_families", "lint_on_card"]


@contextlib.contextmanager
def capture_launches():
    """Record the launches the kernel wrappers make on fake tensors;
    yields the list of ``CapturedLaunch``es. Run the real wrappers inside,
    on fake tensors on the CPU or the card (``graph_walk.fake_mode``):
    their checks run, their outputs are allocated (fake), and nothing
    launches."""
    from repro_torch.analysis import graph_walk

    with capturing() as captured, graph_walk.quiet_fake_pointers():
        yield captured


# ---------------------------------------------------------------------------
# Geometry checks
# ---------------------------------------------------------------------------


def _blocks(grid: Tuple[int, ...], exhaustive: bool):
    if exhaustive:
        return itertools.product(*(range(g) for g in grid))
    return itertools.product(*(sorted({0, g - 1}) for g in grid))


def _tile_starts(tile: Tile, point: Tuple[int, int, int]) -> List[tuple]:
    index = tile.index(*point)
    return index if isinstance(index, list) else [index]


def _tile_findings(tile: Tile, grid: Tuple[int, ...], site: str,
                   exhaustive: bool,
                   cover: Optional[np.ndarray]) -> List[Finding]:
    """Replay one operand's tile map over the grid: a tile that starts
    past the operand is ``oob-block``; ``cover`` (one cell a tile of the
    operand) gets each tile's cell."""
    shape, block = tuple(tile.shape), tuple(tile.block)
    if len(block) != len(shape):
        return [Finding("oob-block", "error", site,
                        "tile rank %d != operand rank %d"
                        % (len(block), len(shape)))]
    for point in _blocks(grid, exhaustive):
        for index in _tile_starts(tile, point):
            for dim, (i, b, n) in enumerate(zip(index, block, shape)):
                start = int(i) * int(b)
                if start < 0 or start >= n:
                    return [Finding(
                        "oob-block", "error", site,
                        "block %s maps dim %d to offset %d, past operand "
                        "shape %s" % (point, dim, start, shape))]
            if cover is not None:
                cover[tuple(int(i) for i in index)] = True
    return []


def lint_captured(call: CapturedLaunch, *, site: str,
                  smem_budget: float = H100_SMEM_BUDGET) -> List[Finding]:
    """Run every geometry rule over one captured launch."""
    findings: List[Finding] = []
    base = "%s/%s" % (site, call.kernel_name)
    grid = tuple(int(g) for g in call.grid)

    if not grid or any(g <= 0 for g in grid) or grid[0] > MAX_GRID_X \
            or any(g > MAX_GRID_YZ for g in grid[1:]):
        findings.append(Finding(
            "empty-grid", "error", base,
            "grid %s has a dimension <= 0 or past the card's limits"
            % (grid,)))
        return _sorted(findings)

    threads = int(np.prod(call.block))
    if min(call.block) <= 0 or threads > MAX_THREADS \
            or threads > call.launch_bounds:
        findings.append(Finding(
            "block-shape", "error", base,
            "block %s of %d threads; the card takes %d, the kernel's "
            "__launch_bounds__ %d" % (tuple(call.block), threads,
                                      MAX_THREADS, call.launch_bounds)))

    n_points = int(np.prod(grid))
    exhaustive = n_points <= _MAX_GRID_POINTS
    for tile in call.operands:
        where = "%s/%s" % (base, tile.name)
        cells = tuple(-(-int(n) // int(b))
                      for n, b in zip(tile.shape, tile.block))
        cover = (np.zeros(cells, dtype=bool) if tile.written and exhaustive
                 and len(cells) == len(tile.shape)
                 and int(np.prod(cells)) <= _MAX_COVER_CELLS else None)
        found = _tile_findings(tile, grid, where, exhaustive, cover)
        findings += found
        if cover is not None and not found and not cover.all():
            missing = int(cover.size - cover.sum())
            findings.append(Finding(
                "uncovered-output", "error", where,
                "%d of %d output tiles never written by any block"
                % (missing, cover.size)))

    if call.smem > SMEM_DEFAULT and not call.opt_in:
        findings.append(Finding(
            "smem-opt-in", "warn", base,
            "%d bytes of dynamic shared memory, over 48 KB, without "
            "cudaFuncSetAttribute" % call.smem, value=float(call.smem)))
    if call.smem > smem_budget:
        findings.append(Finding(
            "smem-overflow", "warn", base,
            "dynamic shared memory %.2f KiB exceeds the budget %.2f KiB"
            % (call.smem / 1024, smem_budget / 1024),
            value=float(call.smem)))

    names = {t.name: t for t in call.operands}
    for tile in call.operands:
        if tile.alias is None:
            continue
        src = names.get(tile.alias)
        ok = (src is not None and tuple(src.shape) == tuple(tile.shape)
              and src.dtype == tile.dtype)
        findings.append(Finding(
            "ref-alias", "info" if ok else "error",
            "%s/alias:%s->%s" % (base, tile.alias, tile.name),
            "%s is written in place as %s%s" % (
                tile.alias, tile.name,
                "" if ok else " with mismatched shape/dtype")))
    return _sorted(findings)


def lint_on_card(call: CapturedLaunch, *, site: str
                 ) -> Tuple[List[Finding], Dict[str, Any]]:
    """On the card: the library's plan of ``call`` (``<prefix>_plan``)
    held equal to its Python plan (a ``plan-mismatch`` error where not),
    and the kernel's attributes (``<prefix>_attributes``): 0 blocks an SM
    is ``no-occupancy``, local memory ``register-spill``. Returns
    (findings, {"plan": the library's (grid, block, smem), **the
    attributes})."""
    base = "%s/%s" % (site, call.kernel_name)
    grid, block, smem = plan_on_card(call)
    attrs = attributes_on_card(call)
    findings: List[Finding] = []
    python = (tuple(call.grid), tuple(call.block), int(call.smem))
    if (grid, block, smem) != python:
        findings.append(Finding(
            "plan-mismatch", "error", base,
            "the library launches %s, the Python plan says %s"
            % ((grid, block, smem), python)))
    if attrs["blocks_per_sm"] < 1:
        findings.append(Finding(
            "no-occupancy", "error", base,
            "0 blocks an SM at block %s and %d bytes of shared memory"
            % (block, smem)))
    if attrs["local_bytes"] > 0:
        findings.append(Finding(
            "register-spill", "warn", base,
            "%d bytes of local memory a thread (%d registers)"
            % (attrs["local_bytes"], attrs["registers"]),
            value=float(attrs["local_bytes"])))
    return _sorted(findings), {"plan": [list(grid), list(block), smem],
                               **attrs}


# ---------------------------------------------------------------------------
# Kernel-family entry points (what the CLI lints)
# ---------------------------------------------------------------------------


def _fake(*shape: int, dtype: torch.dtype = torch.float32,
          device: str = "cuda") -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def _run_flash():
    """B3 through its wrappers: the tensor-core forward (bf16, head dim 64,
    causal with a window), the scalar one (f32, head dim 16) at an offset
    with its log-sum-exp, and each backward."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_backward_cuda, flash_attention_cuda)

    q = _fake(1, 2, 256, 64, dtype=torch.bfloat16)
    flash_attention_cuda(q, q, q, causal=True, window=128)
    flash_attention_backward_cuda(q, q, q, q, _fake(1, 2, 256), q)
    k = _fake(1, 2, 256, 16)
    flash_attention_cuda(_fake(1, 2, 64, 16), k, k, q_offset=128,
                         return_lse=True)
    flash_attention_backward_cuda(k, k, k, k, _fake(1, 2, 256), k)


def _run_wkv():
    """B4 through its wrappers: the chunked forward and backward (head dim
    64, 128 tokens), the sequential ones (head dim 16, 40 tokens)."""
    from repro_torch.kernels.wkv.kernel import wkv_backward_cuda, wkv_cuda

    x = _fake(1, 2, 128, 64)
    wkv_cuda(x, x, x, x, _fake(2, 64))
    wkv_backward_cuda(x, x, x, x, _fake(2, 64), x)
    y = _fake(1, 2, 40, 16)
    wkv_cuda(y, y, y, y, _fake(2, 16))
    wkv_backward_cuda(y, y, y, y, _fake(2, 16), y)


def _run_rmsnorm():
    """B2 through its wrappers: the forward in bf16 at D 64 (a warp a row)
    and f32 at D 3072 (256 threads), and the gradient."""
    from repro_torch.kernels.rmsnorm.kernel import (rms_norm_backward_cuda,
                                                    rms_norm_cuda)

    x = _fake(512, 64, dtype=torch.bfloat16)
    rms_norm_cuda(x, _fake(64))
    rms_norm_cuda(_fake(4, 3072), _fake(3072))
    rms_norm_backward_cuda(x, _fake(64), x)


def _run_himeno():
    """B1 through its wrapper, a sweep over a grid of odd sides."""
    from repro_torch.kernels.himeno.kernel import himeno_sweep

    p = _fake(9, 8, 8)
    coef = lambda n: _fake(n, 9, 8, 8)  # noqa: E731
    himeno_sweep(p, coef(4), coef(3), coef(3), p, p)


#: family -> a run of its wrappers on small fake CUDA tensors, by the
#: wrapper each family is named after: flash_attention_cuda, wkv_cuda,
#: rms_norm_cuda and himeno_sweep (and their gradients).
KERNEL_FAMILIES: Dict[str, Callable[[], None]] = {
    "flash_attention": _run_flash,
    "wkv": _run_wkv,
    "rmsnorm": _run_rmsnorm,
    "himeno": _run_himeno,
}


def capture_family(run: Callable[[], None]) -> List[CapturedLaunch]:
    """The launches ``run`` makes through the real wrappers, on fake
    tensors of a fresh ``graph_walk.fake_mode()``."""
    from repro_torch.analysis import graph_walk

    with graph_walk.fake_mode(), capture_launches() as captured:
        run()
    return list(captured)


def lint_kernel_families(families: Sequence[str] = tuple(KERNEL_FAMILIES),
                         ) -> Tuple[List[Finding], Dict[str, int]]:
    """Capture + lint every kernel family's real launches on small shapes.

    Returns (findings, launches-per-family): a family recording no launch
    is itself a finding (the capture missed the kernel entirely).
    """
    findings: List[Finding] = []
    launch_counts: Dict[str, int] = {}
    for family in families:
        captured = capture_family(KERNEL_FAMILIES[family])
        launch_counts[family] = len(captured)
        if not captured:
            findings.append(Finding(
                "no-kernel-launch", "error", "kernels/%s" % family,
                "the family's wrappers recorded no launch under capture"))
        for call in captured:
            findings += lint_captured(call, site="kernels/%s" % family)
    return _sorted(findings), launch_counts


# ---------------------------------------------------------------------------
# The card: the launches the main paths make, at their shapes
# ---------------------------------------------------------------------------

_BF16 = torch.bfloat16


def _flash(b, h, kh, sq, sk, d, dtype, **kw):
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda

    def run():
        flash_attention_cuda(_fake(b, h, sq, d, dtype=dtype),
                             _fake(b, kh, sk, d, dtype=dtype),
                             _fake(b, kh, sk, d, dtype=dtype), **kw)
    return run


def _flash_backward(b, h, kh, s, d, dtype):
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_backward_cuda

    def run():
        q = _fake(b, h, s, d, dtype=dtype)
        kv = _fake(b, kh, s, d, dtype=dtype)
        flash_attention_backward_cuda(q, kv, kv, q, _fake(b, h, s), q)
    return run


def _rms(shape, dtype, backward=False):
    from repro_torch.kernels.rmsnorm.kernel import (rms_norm_backward_cuda,
                                                    rms_norm_cuda)

    def run():
        x = _fake(*shape, dtype=dtype)
        if backward:
            rms_norm_backward_cuda(x, _fake(shape[-1]), x)
        else:
            rms_norm_cuda(x, _fake(shape[-1]))
    return run


def _wkv(b, h, s, d, *, state=False, backward=False):
    from repro_torch.kernels.wkv.kernel import wkv_backward_cuda, wkv_cuda

    def run():
        x = _fake(b, h, s, d)
        if backward:
            wkv_backward_cuda(x, x, x, x, _fake(h, d), x)
        else:
            wkv_cuda(x, x, x, x, _fake(h, d),
                     _fake(b, h, d, d) if state else None)
    return run


def _himeno(sweep):
    from repro_torch.kernels.himeno.kernel import himeno_stencil, himeno_sweep

    def run():
        shape = (512, 256, 256)
        p = _fake(*shape)
        coef = lambda n: _fake(n, *shape)  # noqa: E731
        (himeno_sweep if sweep else himeno_stencil)(p, coef(4), coef(3),
                                                    coef(3), p, p)
    return run


#: case -> a run of one wrapper on fake CUDA tensors at a shape the
#: smoke's main paths launch it at (PERF.md §6): B1 at the L grid; B2 at
#: prefill and decode, and its gradient; B3's tensor-core forward at
#: llama3.2-3b's, zamba2-7b's (D 112), mixtral-8x7b's (window 4096) and
#: seamless-m4t-medium's (D 64, unmasked) prefill, with its log-sum-exp,
#: at a query offset (prefill's seq_inner), the scalar forward in f32 (and
#: at the offset), and both backward pairs; B4's chunked forward at
#: rwkv6-1.6b's prefill, its sequential one at decode, and both backwards.
CARD_CASES: Dict[str, Callable[[], None]] = {
    "himeno_sweep L": _himeno(True),
    "himeno_stencil L": _himeno(False),
    "rms_norm (2,2048,3072) bf16": _rms((2, 2048, 3072), _BF16),
    "rms_norm (2,5760,4096) bf16": _rms((2, 5760, 4096), _BF16),
    "rms_norm (8,1,3072) bf16": _rms((8, 1, 3072), _BF16),
    "rms_norm (2,2048,3072) f32": _rms((2, 2048, 3072), torch.float32),
    "rms_norm_backward (2,2048,3072) bf16": _rms((2, 2048, 3072), _BF16,
                                                 True),
    "rms_norm_backward (2,2048,3072) f32": _rms((2, 2048, 3072),
                                                torch.float32, True),
    "flash (2,24,2048,128) K8": _flash(2, 24, 8, 2048, 2048, 128, _BF16),
    "flash (2,24,2048,128) K8 lse": _flash(2, 24, 8, 2048, 2048, 128, _BF16,
                                           return_lse=True),
    "flash (2,32,2048,112) K32": _flash(2, 32, 32, 2048, 2048, 112, _BF16),
    "flash (2,32,2048,128) K8 window 4096": _flash(
        2, 32, 8, 2048, 2048, 128, _BF16, window=4096),
    "flash (2,16,2048,64) unmasked": _flash(2, 16, 16, 2048, 2048, 64, _BF16,
                                            causal=False),
    "flash (2,24,2048,128) K8 at offset 7*2048 of 32768": _flash(
        2, 24, 8, 2048, 32768, 128, _BF16, q_offset=7 * 2048),
    "flash f32 (2,24,2048,128) K8": _flash(2, 24, 8, 2048, 2048, 128,
                                           torch.float32),
    "flash f32 (2,24,2048,128) K8 at offset 7*2048 of 32768": _flash(
        2, 24, 8, 2048, 32768, 128, torch.float32, q_offset=7 * 2048),
    "flash_backward (2,24,2048,128) K8 bf16": _flash_backward(
        2, 24, 8, 2048, 128, _BF16),
    "flash_backward (2,24,2048,128) K8 f32": _flash_backward(
        2, 24, 8, 2048, 128, torch.float32),
    "wkv (2,32,2048,64)": _wkv(2, 32, 2048, 64),
    "wkv (8,32,1,64) state": _wkv(8, 32, 1, 64, state=True),
    "wkv_backward (2,32,2048,64)": _wkv(2, 32, 2048, 64, backward=True),
    "wkv_backward (2,32,40,64)": _wkv(2, 32, 40, 64, backward=True),
}


def lint_card_cases(cases: Sequence[str] = tuple(CARD_CASES)
                    ) -> Tuple[List[Finding], List[Dict[str, Any]]]:
    """On the card: every case's launches captured through the real
    wrappers, linted (``lint_captured``), their library's plan held equal
    to the Python plan and the kernels' attributes read
    (``lint_on_card``). Returns (findings, a row a launch: case, kernel,
    geometry, the card's attributes and the launch's findings)."""
    findings: List[Finding] = []
    rows: List[Dict[str, Any]] = []
    for case in cases:
        for call in capture_family(CARD_CASES[case]):
            site = "card/%s" % case
            found = lint_captured(call, site=site)
            card, attrs = lint_on_card(call, site=site)
            findings += found + card
            rows.append({"case": case, "kernel": call.kernel_name,
                         "grid": list(call.grid), "block": list(call.block),
                         "smem": call.smem, **attrs,
                         "findings": [f.fid for f in found + card]})
    return _sorted(findings), rows
