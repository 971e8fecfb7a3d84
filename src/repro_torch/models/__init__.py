"""Decoder model for the training path and the serving paths (dense, MoE,
RWKV-hybrid and Griffin stacks; the paged decode takes dense
full-attention stacks)."""
from repro_torch.models.transformer import (
    Runtime,
    StackSpec,
    block_apply,
    build_stacks,
    cache_init,
    decode_step,
    decode_step_paged,
    embed_inputs,
    forward,
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
    "block_apply",
    "build_stacks",
    "cache_init",
    "decode_step",
    "decode_step_paged",
    "embed_inputs",
    "forward",
    "model_init",
    "paged_kv_write",
    "paged_pools_init",
    "paged_supported_reason",
    "prefill",
    "unembed",
]
