"""WKV (RWKV6): kernel B4, its plain version and entry point."""
from repro_torch.kernels.wkv.kernel import wkv_cuda
from repro_torch.kernels.wkv.ops import wkv
from repro_torch.kernels.wkv.ref import wkv_ref

__all__ = ["wkv", "wkv_cuda", "wkv_ref"]
