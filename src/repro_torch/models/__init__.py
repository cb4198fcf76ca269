"""The port's LMs (dense, MoE, RWKV, hybrid, enc-dec and VLM families):
parameters, forward (prefill) and decode."""
from repro_torch.models.inputs import batch_structure, synthetic_batch
from repro_torch.models import moe
from repro_torch.models.transformer import (
    TransformerLM,
    decode_state_cache_keys,
    decode_step,
    forward,
    init_decode_state,
    init_params,
    model_defs,
    reset_decode_slots,
)
from repro_torch.models.weights import params_from_reference

__all__ = [
    "TransformerLM",
    "batch_structure",
    "decode_state_cache_keys",
    "decode_step",
    "forward",
    "init_decode_state",
    "init_params",
    "model_defs",
    "moe",
    "params_from_reference",
    "reset_decode_slots",
    "synthetic_batch",
]
