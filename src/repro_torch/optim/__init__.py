"""Optimizers, LR schedules and gradient compression of the port's
training path, counterparts of the JAX package's ``optim/``."""
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_update, global_norm, init_opt_state,
)
from repro_torch.optim.schedule import rsqrt, warmup_cosine
from repro_torch.optim.grad_compression import (
    compress, compress_with_feedback, decompress, init_error_feedback,
)

__all__ = [
    "AdamWConfig", "adamw_update", "global_norm", "init_opt_state",
    "rsqrt", "warmup_cosine",
    "compress", "compress_with_feedback", "decompress", "init_error_feedback",
]
