"""RMSNorm: kernel B2, its gradient kernel, their plain versions and entry
point."""
from repro_torch.kernels.rmsnorm.kernel import (rms_norm_backward_cuda,
                                                rms_norm_cuda)
from repro_torch.kernels.rmsnorm.ops import rms_norm
from repro_torch.kernels.rmsnorm.ref import (rms_norm_backward_ref,
                                             rms_norm_ref)

__all__ = ["rms_norm", "rms_norm_backward_cuda", "rms_norm_backward_ref",
           "rms_norm_cuda", "rms_norm_ref"]
