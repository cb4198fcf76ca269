"""Hand-written Hopper kernels of the port, each beside its plain version.

B1, the Himeno Jacobi sweep (``kernels/himeno``), B2, RMSNorm
(``kernels/rmsnorm``), B3, the flash-attention forward
(``kernels/flash_attention``), and B4, the RWKV6 WKV recurrence
(``kernels/wkv``), are ported; ``_build.py`` builds and loads their CUDA
sources.
"""
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.himeno.ops import himeno_run, himeno_step
from repro_torch.kernels.rmsnorm.ops import rms_norm
from repro_torch.kernels.wkv.ops import wkv

__all__ = ["flash_attention", "himeno_run", "himeno_step", "rms_norm",
           "wkv"]
