"""Decoder model for the serving path (dense full-attention stacks)."""
from repro_torch.models.transformer import (
    Runtime,
    StackSpec,
    build_stacks,
    decode_step_paged,
    embed_inputs,
    model_init,
    paged_kv_write,
    paged_pools_init,
    paged_supported_reason,
    prefill,
    unembed,
)

__all__ = [
    "Runtime",
    "StackSpec",
    "build_stacks",
    "decode_step_paged",
    "embed_inputs",
    "model_init",
    "paged_kv_write",
    "paged_pools_init",
    "paged_supported_reason",
    "prefill",
    "unembed",
]
