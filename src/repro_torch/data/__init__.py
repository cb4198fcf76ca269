"""The port's training data: the deterministic synthetic LM stream and its
prefetch thread, counterparts of the JAX package's ``data/``."""
from repro_torch.data.pipeline import (
    DataConfig, PrefetchIterator, SyntheticLMStream, device_put_batch,
)

__all__ = ["DataConfig", "PrefetchIterator", "SyntheticLMStream",
           "device_put_batch"]
