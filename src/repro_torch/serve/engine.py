"""The decode engine on the mask cache: continuous batching over a paged
KV cache with per-request dropout schedules.

One engine owns:

  * the physical KV page pools (``models.transformer.paged_pools_init``)
    plus a ``PagePool`` free-list allocator and per-request page tables;
  * a ``ContinuousBatchingScheduler`` driving the
    admit -> prefill -> decode -> retire loop over a bounded slot budget;
  * a ``ScheduleBucketCache`` (one compiled ``DropoutSchedule`` template
    per shape bucket, reseeded per request);
  * a ``PackedMaskCache`` holding each request's per-layer packed mask
    planes on the device, so every decode step's dropout row is a slice
    of a resident plane (one Philox kernel launch per request and layer);
  * the admission-time ``DropoutContract`` per request, re-verified
    through ``checkpoint.contract.verify_resume`` whenever a schedule
    template moves: a realization drift must re-prove itself through the
    counter layer, an identity drift fails fast.

The engine clock is wall time with fast-forward over idle gaps. Every
step ends by copying its logits to the host, which synchronizes the
device, so the latencies measure finished work.

Not ported yet: speculative decoding (``spec_k > 1`` raises).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.contract import (
    contract_from_schedule,
    verify_resume,
)
from repro_torch.config.base import DropoutPlanConfig, ModelConfig
from repro_torch.core.schedule import (
    ScheduleBucket,
    compile_schedule,
    reseed_schedule,
)
from repro_torch.device import DeviceLike, device_of, resolve_device
from repro_torch.models import (
    Runtime,
    build_stacks,
    decode_step_paged,
    model_init,
    paged_kv_write,
    paged_pools_init,
    paged_supported_reason,
    prefill,
)
from repro_torch.serve.mask_cache import PackedMaskCache
from repro_torch.serve.paged_kv import PagePool
from repro_torch.serve.scheduler import (
    ContinuousBatchingScheduler,
    Request,
    ScheduleBucketCache,
)


class EngineUnsupportedError(ValueError):
    """The arch falls outside the paged decode path's coverage."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs. ``max_model_len`` must divide into pages and into
    32-bit packed mask rows; admission rejects requests beyond it."""
    max_slots: int = 8
    page_size: int = 16
    num_pages: int = 128
    max_model_len: int = 256
    prompt_bucket: int = 16         # prefill shape bucket (right-padded)
    mask_decode: bool = True        # apply cached dropout rows in decode
    spec_k: int = 0                 # >1: speculative decode (not ported)
    mask_cache_capacity: int = 256
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.max_model_len % self.page_size:
            raise ValueError("max_model_len must be a multiple of "
                             "page_size")
        if self.max_model_len % 32:
            raise ValueError("max_model_len must be a multiple of 32 "
                             "(packed mask rows)")
        if self.prompt_bucket <= 0:
            raise ValueError("prompt_bucket must be positive")


@dataclasses.dataclass
class ServeReport:
    """Aggregate of one ``ServeEngine.run``."""
    arch: str
    n_requests: int
    total_new_tokens: int
    wall_s: float
    tokens_per_s: float
    latency_first_token_s: Dict[str, float]
    latency_completion_s: Dict[str, float]
    mask_cache: Dict[str, int]
    schedule_cache: Dict[str, int]
    scheduler: Dict[str, int]
    paged_kv: Dict[str, int]

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _percentiles(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"p50": 0.0, "p99": 0.0, "mean": 0.0}
    a = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean())}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class ServeEngine:
    def __init__(self, cfg: ModelConfig,
                 plan: Optional[DropoutPlanConfig] = None,
                 serve: ServeConfig = ServeConfig(),
                 params=None, init_seed: int = 0,
                 device: DeviceLike = None):
        reason = paged_supported_reason(cfg)
        if reason is not None:
            raise EngineUnsupportedError(
                f"arch {cfg.name!r} not servable by the paged decode "
                f"engine: {reason}")
        if serve.spec_k > 1:
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP: port "
                "queue, speculative decode)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.serve = serve
        self.plan = plan or DropoutPlanConfig(
            mode="overlap", p=cfg.attn_dropout, seed=init_seed)
        self.masked = (serve.mask_decode and self.plan.enabled
                       and self.plan.mode == "overlap"
                       and self.plan.p > 0.0)
        self._rt = Runtime(plan=None, compute_dtype=serve.dtype)
        if params is None:
            params = model_init(cfg, seed=init_seed, device=self.device)
        elif device_of(params) != self.device:
            raise ValueError(f"params live on {device_of(params)}, the "
                             f"engine on {self.device}")
        self.params = params
        # physical pools: page area + a private scratch column per slot so
        # idle slots write garbage nowhere near a live page
        self._scratch_base = serve.num_pages * serve.page_size
        n_phys = self._scratch_base + serve.max_slots
        self.pools = paged_pools_init(cfg, n_phys, serve.dtype, self.device)
        self.pool_alloc = PagePool(serve.num_pages, serve.page_size)
        self.scheduler = ContinuousBatchingScheduler(
            self.pool_alloc, serve.max_slots, serve.max_model_len)
        self.mask_cache = PackedMaskCache(serve.mask_cache_capacity,
                                          device=self.device)
        self.schedule_buckets = ScheduleBucketCache()
        # (max_slots, W) logical->physical map; idle rows all-zero
        self._phys = np.zeros((serve.max_slots, serve.max_model_len),
                              np.int32)
        self._next_request_id = 0
        self.nonfinite_logits = 0       # steps whose logits held inf/nan

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _host_logits(self, logits: torch.Tensor) -> np.ndarray:
        out = logits.cpu().numpy()
        self.nonfinite_logits += int(not np.isfinite(out).all())
        return out

    # ------------------------------------------------------------ admin
    def make_request(self, prompt: List[int], max_new_tokens: int,
                     arrival_time: float = 0.0) -> Request:
        req = Request(request_id=self._next_request_id,
                      prompt=list(map(int, prompt)),
                      max_new_tokens=int(max_new_tokens),
                      arrival_time=float(arrival_time))
        self._next_request_id += 1
        return req

    def request_seed(self, req: Request) -> int:
        """Per-request mask seed: requests must not share dropout bits,
        but the same request draws the same bits in any engine."""
        return (self.plan.seed + 0x9E3779B1 * (req.request_id + 1)) \
            & 0x7FFFFFFF

    def _admission_schedule(self, req: Request):
        cap = req.prompt_len + req.max_new_tokens
        mask_seq = _round_up(cap, 32)
        bucket = ScheduleBucket.of(self.cfg, self.plan, batch=1,
                                   seq=mask_seq)
        template, gen = self.schedule_buckets.get(
            bucket, lambda: compile_schedule(
                self.cfg, self.plan, 1, mask_seq))
        sched = reseed_schedule(template, self.request_seed(req))
        req.bucket = bucket
        req.mask_seq = mask_seq
        req.schedule = sched
        req.contract = contract_from_schedule(self.cfg, sched)
        req.contract_generation = gen

    def verify_request_contract(self, req: Request) -> str:
        """Fail fast when a request's schedule realization drifts from its
        admission-time ``DropoutContract`` (the bucket template was
        replaced since admission): a realization drift must re-prove
        itself through the counter layer ("recompiled"); an identity drift
        (different bits) raises ContractMismatchError, never a silent
        recompile."""
        gen = self.schedule_buckets.generation(req.bucket)
        if gen == req.contract_generation:
            return "verified"
        template, gen = self.schedule_buckets.get(req.bucket, None)
        sched = reseed_schedule(template, self.request_seed(req))
        current = contract_from_schedule(self.cfg, sched)
        verdict = verify_resume(req.contract, current, self.cfg, sched)
        req.schedule = sched
        req.contract = current
        req.contract_generation = gen
        return verdict

    # ---------------------------------------------------------- prefill
    def _prefill_request(self, req: Request, now: float) -> None:
        plen = req.prompt_len
        bucket = _round_up(plen, self.serve.prompt_bucket)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :plen] = req.prompt
        logits, caches = prefill(self.params, self.cfg, self._rt,
                                 self._to_device(toks), capacity=bucket,
                                 last_pos=plen - 1)
        # scatter the prompt's KV columns into the request's pages
        slots = self._to_device(np.asarray(
            [req.alloc.physical_slot(i) for i in range(plen)], np.int64))
        for stack_pools, stack_cache in zip(self.pools, caches):
            for lkey, pool in stack_pools.items():
                for f in ("k", "v"):
                    cols = stack_cache[lkey][f][:, 0, :, :plen, :]
                    pool[f][:, :, slots, :] = cols.to(pool[f].dtype)
        req.length = plen
        self._phys[req.slot] = req.alloc.physical_index(
            self.serve.max_model_len)
        tok = int(np.argmax(self._host_logits(logits)[0, -1]))
        req.output.append(tok)
        req.t_first_token = now

    # ------------------------------------------------------- mask rows
    def mask_plane(self, req: Request, layer: int) -> torch.Tensor:
        """The request's packed (1, H, S//32, S) mask plane for one
        layer — resident in the LRU after first use."""
        shape = (1, self.cfg.n_heads, req.mask_seq, req.mask_seq)
        return self.mask_cache.get_or_create(req.schedule, layer, 0,
                                             shape)

    def _keep_rows(self, active: List[Request], positions: np.ndarray,
                   g: int):
        """Per-stack keep-row tensors (count, B, H, g, W) sliced on the
        device from the active requests' resident planes: word
        ``qpos // 32``, bit ``qpos % 32`` of each plane."""
        B, W = self.serve.max_slots, self.serve.max_model_len
        H, L = self.cfg.n_heads, self.cfg.n_layers
        keep = torch.zeros((L, B, H, g, W), dtype=torch.bool,
                           device=self.device)
        for req in active:
            planes = [self.mask_plane(req, layer) for layer in range(L)]
            for j in range(g):
                qpos = int(positions[req.slot, j])
                words = torch.stack([pl[0, :, qpos // 32, :]
                                     for pl in planes])      # (L, H, S)
                keep[:, req.slot, :, j, :req.mask_seq] = \
                    ((words >> (qpos % 32)) & 1).to(torch.bool)
        out, base = [], 0
        for spec in build_stacks(self.cfg):
            ul = len(spec.unit)
            out.append({f"l{j}": keep[base + j:base + spec.count * ul:ul]
                        for j in range(ul)})
            base += spec.count * ul
        return out

    # --------------------------------------------------------- stepping
    def _write_slots(self, active: List[Request],
                     positions: np.ndarray, g: int) -> np.ndarray:
        """(B, g) physical write slots: the request's page slot for its
        positions; idle slots target their private scratch column."""
        B = self.serve.max_slots
        slots = np.repeat(self._scratch_base + np.arange(B, dtype=np.int64)
                          [:, None], g, axis=1)
        for req in active:
            for j in range(g):
                slots[req.slot, j] = req.alloc.physical_slot(
                    int(positions[req.slot, j]))
        return slots

    def step_batch(self, active: List[Request], tokens: np.ndarray,
                   positions: np.ndarray, *, write: bool) -> np.ndarray:
        """One paged step over the full slot batch. tokens / positions
        (max_slots, g); returns logits (max_slots, g, V) on the host."""
        g = tokens.shape[1]
        keep = (self._keep_rows(active, positions, g)
                if self.masked else None)
        logits, updates = decode_step_paged(
            self.params, self.cfg, self._rt,
            self._to_device(tokens.astype(np.int64)), self.pools,
            self._to_device(self._phys.astype(np.int64)),
            self._to_device(positions.astype(np.int64)),
            keep_rows=keep, p_drop=self.plan.p if self.masked else 0.0)
        if write:
            slots = self._write_slots(active, positions, g)
            self.pools = paged_kv_write(self.pools, updates,
                                        self._to_device(slots))
        return self._host_logits(logits)

    def decode_round(self, active: List[Request]) -> None:
        """Plain continuous-batching round: one token per active slot."""
        B = self.serve.max_slots
        tokens = np.zeros((B, 1), np.int32)
        positions = np.zeros((B, 1), np.int32)
        for req in active:
            tokens[req.slot, 0] = req.last_token()
            positions[req.slot, 0] = req.length
        logits = self.step_batch(active, tokens, positions, write=True)
        for req in active:
            req.length += 1
            req.output.append(int(np.argmax(logits[req.slot, 0])))

    # -------------------------------------------------------- main loop
    def submit(self, req: Request) -> None:
        self.scheduler.submit(req)

    def _admit_all(self, now: float) -> None:
        while True:
            req = self.scheduler.admit_next()
            if req is None:
                return
            req.t_admitted = now
            self._admission_schedule(req)
            self._prefill_request(req, now)

    def _retire_done(self, now: float) -> List[Request]:
        done = [r for r in self.scheduler.running.values() if r.done]
        for req in done:
            req.output = req.output[:req.max_new_tokens]
            req.t_finished = now
            self._phys[req.slot] = 0
            self.scheduler.retire(req)
        return done

    def run(self, requests: List[Request]) -> ServeReport:
        """Drive the admit/prefill/decode/retire loop until every request
        completes. ``arrival_time`` is an offset (seconds) on the engine
        clock; idle gaps fast-forward."""
        pending = sorted(requests, key=lambda r:
                         (r.arrival_time, r.request_id))
        t0 = time.perf_counter()
        skew = 0.0
        finished: List[Request] = []
        while pending or not self.scheduler.idle:
            now = time.perf_counter() - t0 + skew
            while pending and pending[0].arrival_time <= now:
                self.submit(pending.pop(0))
            if (pending and self.scheduler.idle
                    and not self.scheduler.queue):
                skew += pending[0].arrival_time - now
                continue
            self._admit_all(now)
            active = sorted(self.scheduler.running.values(),
                            key=lambda r: r.slot)
            active = [r for r in active if not r.done]
            if active:
                self.decode_round(active)
            now = time.perf_counter() - t0 + skew
            finished.extend(self._retire_done(now))
        wall = time.perf_counter() - t0
        return self._report(finished, wall)

    def _report(self, finished: List[Request], wall: float
                ) -> ServeReport:
        total_new = sum(len(r.output) for r in finished)
        first = [r.t_first_token - r.arrival_time for r in finished]
        comp = [r.t_finished - r.arrival_time for r in finished]
        return ServeReport(
            arch=self.cfg.name,
            n_requests=len(finished),
            total_new_tokens=total_new,
            wall_s=wall,
            tokens_per_s=total_new / wall if wall > 0 else 0.0,
            latency_first_token_s=_percentiles(first),
            latency_completion_s=_percentiles(comp),
            mask_cache=self.mask_cache.stats(),
            schedule_cache=self.schedule_buckets.stats(),
            scheduler=self.scheduler.stats(),
            paged_kv=self.pool_alloc.stats())
