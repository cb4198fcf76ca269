"""Flash attention (forward): kernel B3, its plain version and entry point."""
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref

__all__ = ["NEG_INF", "attention_ref", "flash_attention",
           "flash_attention_cuda"]
