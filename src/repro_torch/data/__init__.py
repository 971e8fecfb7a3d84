"""Deterministic synthetic LM data (the JAX package's ``data``)."""
from repro_torch.data.pipeline import (
    Prefetcher,
    batch_for_step,
    device_batch,
    embed_batch_for_step,
)

__all__ = ["Prefetcher", "batch_for_step", "device_batch",
           "embed_batch_for_step"]
