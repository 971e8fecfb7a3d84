"""Packed dropout-mask planes resident across decode steps, keyed by the
schedule's mask identity.

Two fetches agreeing on ``schedule.mask_key(layer, step)`` = (seed, salt,
layer, step, threshold, rounds, bits) consume bit-identical planes
whichever producer made them, so every decode step's dropout row is a
slice of a resident plane and RNG runs once per (request, layer).

Eviction is true LRU: a hit refreshes recency, and ``stats()`` counts
evictions so capacity pressure shows in the serve report.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterator, Tuple

import torch

from repro_torch.device import DeviceLike


class PackedMaskCache:
    """LRU cache of packed (B, H, SQ//32, SK) int32 planes keyed by
    schedule mask identity. ``misses`` count the Philox executions: a
    miss is the only place RNG runs."""

    def __init__(self, capacity: int = 256, device: DeviceLike = None):
        self.capacity = capacity
        self.device = device
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._entries: "collections.OrderedDict[Tuple[int, ...], torch.Tensor]" = (
            collections.OrderedDict())

    def get_or_create(self, schedule, layer: int, step: int,
                      mask_shape: Tuple[int, int, int, int]) -> torch.Tensor:
        """The packed plane for (layer, step) under ``schedule``'s plan:
        made on first use (one Philox execution), served from the cache
        afterwards."""
        key = schedule.mask_key(layer, step)
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.move_to_end(key)     # hits refresh recency
            self.hits += 1
            return hit
        self.misses += 1
        b, h, sq, sk = mask_shape
        from repro_torch.core import producer
        from repro_torch.core.overlap import DropoutPlan
        mask = producer.standalone_packed_mask(
            DropoutPlan(schedule.plan), b, h, sq, sk, layer, step,
            device=self.device)
        self._entries[key] = mask
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return mask

    def items(self) -> Iterator[Tuple[Tuple[int, ...], torch.Tensor]]:
        """(mask_key, plane) of every resident plane, least recent first."""
        return iter(list(self._entries.items()))

    def snapshot_rng(self) -> int:
        """Philox-execution counter (== misses)."""
        return self.misses

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "entries": len(self._entries)}
