"""Public entry points for the Himeno Jacobi sweep.

``impl="auto"`` goes through the kernel wrapper: the CUDA kernel for tensors
on the card, its plain PyTorch version for tensors on the CPU.
``impl="ref"`` runs the plain version wherever the tensors lie.
"""
from __future__ import annotations

from repro_torch.kernels.himeno.kernel import himeno_sweep
from repro_torch.kernels.himeno.ref import jacobi_ref

IMPLS = ("auto", "ref")


def himeno_step(p, a, b, c, bnd, wrk1, *, omega: float = 0.8,
                impl: str = "auto"):
    """One Jacobi sweep: (p_new, gosa)."""
    if impl == "auto":
        return himeno_sweep(p, a, b, c, bnd, wrk1, omega=omega)
    if impl == "ref":
        return jacobi_ref(p, a, b, c, bnd, wrk1, omega=omega)
    raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def himeno_run(state: dict, iters: int, *, omega: float = 0.8,
               impl: str = "auto"):
    """iters Jacobi sweeps in a host loop; returns (final p, last gosa)."""
    if iters < 1:
        raise ValueError("iters must be >= 1")
    p = state["p"]
    for _ in range(iters):
        p, gosa = himeno_step(p, state["a"], state["b"], state["c"],
                              state["bnd"], state["wrk1"], omega=omega,
                              impl=impl)
    return p, gosa
