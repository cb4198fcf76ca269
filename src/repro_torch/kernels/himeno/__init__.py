"""The Himeno Jacobi sweep: kernel B1, its plain version and entry points."""
from repro_torch.kernels.himeno.kernel import himeno_stencil, himeno_sweep
from repro_torch.kernels.himeno.ops import himeno_run, himeno_step
from repro_torch.kernels.himeno.ref import (
    himeno_init, jacobi_ref, state_from_reference, stencil_parts_ref,
    stencil_ref,
)

__all__ = [
    "himeno_stencil", "himeno_sweep", "himeno_run", "himeno_step",
    "himeno_init", "jacobi_ref", "state_from_reference", "stencil_parts_ref",
    "stencil_ref",
]
