"""Plain PyTorch versions of the Himeno 19-point stencil Jacobi step.

The same arithmetic as the JAX package's ``kernels/himeno/ref.py`` (the
RIKEN Himeno benchmark: pressure Poisson solve, Jacobi iteration, full
coefficient arrays a(4), b(3), c(3), bnd, wrk1). They are what the kernel
wrappers in ``kernel.py`` run for tensors on the CPU, and what the CUDA
kernel is held against on the card.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch._device import resolve_device

FLOPS_PER_POINT = 34  # the benchmark's own accounting
ARRAYS = ("p", "a", "b", "c", "bnd", "wrk1")

_C = slice(1, -1)
_P, _N = slice(2, None), slice(0, -2)  # +1 / -1 shifts on the interior


def himeno_init(shape: tuple[int, int, int], dtype=torch.float32,
                device=None) -> dict[str, torch.Tensor]:
    """Standard Himeno initialization: p = (k/(K-1))^2, unit coefficients.

    ``device=None`` builds the state on the card and raises without CUDA."""
    device = resolve_device(device)
    i, j, k = shape
    kk = torch.arange(k, dtype=dtype, device=device)
    p = ((kk / (k - 1)) ** 2)[None, None, :].expand(shape).contiguous()
    ones = torch.ones(shape, dtype=dtype, device=device)
    a = torch.stack([ones] * 3 + [torch.full_like(ones, 1.0 / 6.0)])
    b = torch.zeros((3,) + shape, dtype=dtype, device=device)
    c = torch.ones((3,) + shape, dtype=dtype, device=device)
    bnd = torch.ones(shape, dtype=dtype, device=device)
    wrk1 = torch.zeros(shape, dtype=dtype, device=device)
    return dict(p=p, a=a, b=b, c=c, bnd=bnd, wrk1=wrk1)


def state_from_reference(state: Mapping[str, np.ndarray], device
                         ) -> dict[str, torch.Tensor]:
    """Carry a reference state (``himeno_init`` or app arrays, as numpy)
    across to contiguous f32 tensors on ``device``."""
    dev = resolve_device(device)
    # np.array copies, so the tensors never alias the reference's arrays
    return {name: torch.from_numpy(np.array(state[name], dtype=np.float32,
                                            order="C")).to(dev)
            for name in ARRAYS}


def stencil_ref(p, a, b, c, bnd, wrk1):
    """The interior residual ss, shape (I-2, J-2, K-2)."""
    C, P, N = _C, _P, _N
    s0 = (
        a[0][C, C, C] * p[P, C, C]
        + a[1][C, C, C] * p[C, P, C]
        + a[2][C, C, C] * p[C, C, P]
        + b[0][C, C, C] * (p[P, P, C] - p[P, N, C] - p[N, P, C] + p[N, N, C])
        + b[1][C, C, C] * (p[C, P, P] - p[C, N, P] - p[C, P, N] + p[C, N, N])
        + b[2][C, C, C] * (p[P, C, P] - p[N, C, P] - p[P, C, N] + p[N, C, N])
        + c[0][C, C, C] * p[N, C, C]
        + c[1][C, C, C] * p[C, N, C]
        + c[2][C, C, C] * p[C, C, N]
        + wrk1[C, C, C]
    )
    return (s0 * a[3][C, C, C] - p[C, C, C]) * bnd[C, C, C]


def stencil_parts_ref(p, a, b, c, bnd, wrk1):
    """The stencil entry's function: (ss, gosa partials, one per i-slab)."""
    ss = stencil_ref(p, a, b, c, bnd, wrk1)
    return ss, torch.square(ss).sum(dim=(1, 2))


def jacobi_ref(p, a, b, c, bnd, wrk1, omega: float = 0.8):
    """One Jacobi sweep. All arrays (I,J,K) except a:(4,I,J,K), b/c:(3,I,J,K).

    Returns (p_new, gosa) with boundaries of p passed through unchanged."""
    ss = stencil_ref(p, a, b, c, bnd, wrk1)
    gosa = torch.sum(torch.square(ss))
    p_new = p.clone()
    p_new[_C, _C, _C] += omega * ss
    return p_new, gosa
