"""Hand-written Hopper kernels of the port, each beside its plain version.

B1, the Himeno Jacobi sweep, is ported (``kernels/himeno``). RMSNorm, flash
attention and WKV follow with the slices that run them.
"""
from repro_torch.kernels.himeno.ops import himeno_run, himeno_step

__all__ = ["himeno_run", "himeno_step"]
