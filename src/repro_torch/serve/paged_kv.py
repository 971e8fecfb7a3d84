"""Paged KV cache: fixed-size pages, per-request page tables, free-list
allocation — the vLLM-style memory model, replacing the contiguous
per-request capacity caches of ``attn_cache_init`` for serving.

Physical layout: one (KV, S_phys, head_dim) pool per attention layer
(``models.transformer.paged_pools_init``), where
``S_phys = num_pages * page_size + scratch``. A request holds an ordered
list of page ids; logical position ``i`` lives at physical slot
``pages[i // page_size] * page_size + i % page_size``. Attention gathers
through that map (``attn_decode_paged``), so any free page serves any
request — capacity fragments across pages but never strands: an
allocation succeeds iff enough pages are free, contiguity irrelevant.

The scratch tail gives every idle batch slot a private write target so
the decode step keeps a fixed shape without masking writes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


class OutOfPagesError(RuntimeError):
    """More pages requested than the pool can ever hold."""


@dataclasses.dataclass
class PageAllocation:
    """One request's pages, in logical order."""
    pages: List[int]
    page_size: int

    @property
    def capacity(self) -> int:
        return len(self.pages) * self.page_size

    def physical_slot(self, pos: int) -> int:
        return (self.pages[pos // self.page_size] * self.page_size
                + pos % self.page_size)

    def physical_index(self, width: int) -> np.ndarray:
        """(width,) int32 logical→physical map, padded with slot 0 past
        this allocation's capacity (those entries are masked by the
        causal validity rule — a position is only readable once
        written, and writes never pass capacity)."""
        idx = np.zeros((width,), np.int32)
        n = min(self.capacity, width)
        pos = np.arange(n)
        pages = np.asarray(self.pages, np.int32)
        idx[:n] = pages[pos // self.page_size] * self.page_size \
            + pos % self.page_size
        return idx


class PagePool:
    """Host-side free-list allocator over ``num_pages`` fixed pages.

    LIFO free list (freed pages are reused first — hottest pool slots
    stay resident) with high-water and failure accounting for the serve
    report."""

    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self.allocs = 0
        self.alloc_failures = 0
        self.peak_pages_in_use = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def allocate(self, n_pages: int) -> Optional[PageAllocation]:
        """n_pages in any physical order, or None under pressure (the
        scheduler keeps the request queued). Raises OutOfPagesError when
        the pool could NEVER satisfy it — queueing would deadlock."""
        if n_pages > self.num_pages:
            raise OutOfPagesError(
                f"request needs {n_pages} pages; pool holds only "
                f"{self.num_pages} (page_size={self.page_size})")
        if n_pages > len(self._free):
            self.alloc_failures += 1
            return None
        pages = [self._free.pop() for _ in range(n_pages)]
        self.allocs += 1
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages_in_use)
        return PageAllocation(pages=pages, page_size=self.page_size)

    def free(self, alloc: PageAllocation) -> None:
        for p in alloc.pages:
            assert 0 <= p < self.num_pages and p not in self._free, \
                f"double free of page {p}"
            self._free.append(p)

    def stats(self) -> Dict[str, int]:
        return {"num_pages": self.num_pages,
                "page_size": self.page_size,
                "pages_in_use": self.pages_in_use,
                "peak_pages_in_use": self.peak_pages_in_use,
                "allocs": self.allocs,
                "alloc_failures": self.alloc_failures}
