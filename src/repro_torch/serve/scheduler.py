"""Continuous-batching scheduler: request lifecycle, admission under
page/slot pressure, and the cache of compiled dropout schedules per
shape bucket.

Request lifecycle::

    QUEUED --admit--> PREFILLING --first token--> RUNNING --max_new-->
    FINISHED (pages + slot reclaimed; the next queued request admits)

Admission is all-or-nothing per request: a batch slot AND every KV page
the request can ever need (ceil((prompt + max_new) / page_size)) are
reserved up front, so a running request never stalls mid-generation on
allocation — under pressure requests wait in the queue instead
(scheduling pressure may delay a request but can never change its mask
bits).

At admission each request gets its own ``DropoutSchedule``: one compiled
template per ``ScheduleBucket``, reseeded per request
(``reseed_schedule``), and the ``DropoutContract`` frozen from it. The
engine re-checks that contract against the bucket's template generation
(``ServeEngine.verify_request_contract``).
"""
from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.serve.paged_kv import PageAllocation, PagePool


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One user request riding through the engine."""
    request_id: int
    prompt: List[int]
    max_new_tokens: int
    arrival_time: float = 0.0

    # engine-managed state
    state: RequestState = RequestState.QUEUED
    slot: int = -1
    alloc: Optional[PageAllocation] = None
    schedule: Any = None              # per-request DropoutSchedule
    bucket: Any = None                # ScheduleBucket key
    contract: Any = None              # admission-time DropoutContract
    contract_generation: int = -1     # bucket-cache generation verified
    mask_seq: int = 0                 # packed-plane seq (multiple of 32)
    length: int = 0                   # tokens written to pages
    output: List[int] = dataclasses.field(default_factory=list)
    t_admitted: float = -1.0
    t_first_token: float = -1.0
    t_finished: float = -1.0

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        return len(self.output) >= self.max_new_tokens

    def last_token(self) -> int:
        return self.output[-1] if self.output else self.prompt[-1]


class ScheduleBucketCache:
    """Compiled-schedule templates keyed by ``ScheduleBucket``.

    One ``compile_schedule`` per shape bucket; every further request in
    the bucket stamps its schedule out by reseeding the template. Each
    entry carries a ``generation`` counter: replacing a template (a config
    push, code drift) bumps it, which tells the engine to re-verify every
    affected request's admission-time DropoutContract before using the new
    template."""

    def __init__(self):
        self._entries: Dict[Any, Tuple[Any, int]] = {}
        self.hits = 0
        self.misses = 0

    def get(self, bucket, compile_fn):
        """(template, generation) of ``bucket``, compiling on a miss."""
        ent = self._entries.get(bucket)
        if ent is not None:
            self.hits += 1
            return ent
        self.misses += 1
        ent = self._entries[bucket] = (compile_fn(), 0)
        return ent

    def generation(self, bucket) -> int:
        ent = self._entries.get(bucket)
        return -1 if ent is None else ent[1]

    def replace(self, bucket, template) -> int:
        """Swap a bucket's template, bumping its generation (drift
        injection for tests, hot config pushes)."""
        gen = self.generation(bucket) + 1
        self._entries[bucket] = (template, gen)
        return gen

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._entries)}


class ContinuousBatchingScheduler:
    """Admission + retirement over a bounded slot/page budget."""

    def __init__(self, pool: PagePool, max_slots: int,
                 max_model_len: int):
        self.pool = pool
        self.max_slots = max_slots
        self.max_model_len = max_model_len
        self.queue: "collections.deque[Request]" = collections.deque()
        self.running: Dict[int, Request] = {}      # slot -> request
        self._free_slots = list(range(max_slots - 1, -1, -1))
        self.admitted = 0
        self.retired = 0
        self.peak_running = 0

    def submit(self, req: Request) -> None:
        cap = req.prompt_len + req.max_new_tokens
        if cap > self.max_model_len:
            raise ValueError(
                f"request {req.request_id}: prompt+max_new={cap} "
                f"exceeds max_model_len={self.max_model_len}")
        self.queue.append(req)

    def admit_next(self) -> Optional[Request]:
        """Admit the head-of-line request if a slot AND its full page
        budget are available (FCFS — no head-of-line bypass, so
        admission order is deterministic given arrival order)."""
        if not self.queue or not self._free_slots:
            return None
        req = self.queue[0]
        need = self.pool.pages_needed(req.prompt_len
                                      + req.max_new_tokens)
        alloc = self.pool.allocate(need)
        if alloc is None:
            return None
        self.queue.popleft()
        req.alloc = alloc
        req.slot = self._free_slots.pop()
        req.state = RequestState.RUNNING
        self.running[req.slot] = req
        self.admitted += 1
        self.peak_running = max(self.peak_running, len(self.running))
        return req

    def retire(self, req: Request) -> None:
        assert req.slot in self.running
        del self.running[req.slot]
        self._free_slots.append(req.slot)
        self.pool.free(req.alloc)
        req.alloc = None
        req.state = RequestState.FINISHED
        self.retired += 1

    @property
    def idle(self) -> bool:
        return not self.queue and not self.running

    def stats(self) -> Dict[str, int]:
        return {"admitted": self.admitted, "retired": self.retired,
                "queued": len(self.queue),
                "running": len(self.running),
                "peak_running": self.peak_running}
