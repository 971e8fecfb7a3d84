"""Deterministic synthetic LM data (the JAX package's ``data``)."""
from repro_torch.data.pipeline import batch_for_step, embed_batch_for_step

__all__ = ["batch_for_step", "embed_batch_for_step"]
