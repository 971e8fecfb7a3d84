"""Layer 1 of the static mask-safety verifier: Philox counter-space
analysis of a compiled DropoutSchedule, proven over what the port's CUDA
kernels execute.

Every mask producer of the port draws from one counter scheme
(kernels/philox_common.py): element (b, h, q, k) of layer L at step S reads
counter (x0=k, x1=q//4, x2=b*H+h, x3=salt(L)) under key step_seed(S). A
compiled schedule is mask-safe iff, per (layer, step) identity,

  * every kernel that makes or re-derives the plane draws each word of the
    region it must cover once: no double draw, no dead bits,
  * shard-local producers' (bh_offset, b_loc, h_loc) windows exactly tile
    the global (B, H) counter plane,
  * every consumer has exactly one live emission, the carried
    ``emit_stride`` pipeline lands on the layer that consumes it, and
  * no two (layer, stream) identities fold to the same uint32 salt.

The checks and the rule IDs are the JAX package's (``repro/analysis/
counters.py``). What differs is the enumeration: each ``how`` is walked as
the port's kernels walk it, not as the TPU grids do, and each is proven
over the region below.

  * ``HOW_GEMM`` / ``HOW_GEMM_GROUPED`` (the fused hosts): the whole local
    packed plane, rows_valid = b_loc * h_loc * SQ/32 by SK words. The
    rectangles are JAX's (``kernels/gemm_rng.py::mask_emission_layout`` on
    the JAX logical grid; ``csrc/gemm_emit.cuh`` writes exactly those), and
    they must tile the plane. Then each kernel instance the plan can run
    splits the words among its CTAs (``CtaRuns``), and the runs must
    partition them with no overlap and no gap: ``emit_share`` of the f32
    and e4m3 kernels cuts the rectangles' words, in block order, into one
    equal run per CTA of the E x tiles_m x tiles_n grid (128 x 128 tiles);
    the persistent bf16 kernels (``csrc/gemm_walk.cuh``) cut the plane's
    32-word row units into one run per CTA of the resident grid.
  * ``HOW_STANDALONE`` (``csrc/philox_walk.cuh``): the whole local plane.
    Thread i of a persistent grid of S threads takes groups i, i+S, ...
    of WORDS = 4 consecutive words of a row, the last group of a row
    short (``StrideWalk``), proven in closed form over the residues.
  * ``HOW_REPLAY`` (the flash kernels re-derive the bits in-register): the
    region that attention consumes. A packed row (32 queries) needs the
    keys that at least one of its queries attends: causal, and inside the
    window of a LOCAL layer. Each flash kernel instance's visited tiles
    (``TileWalk``: forward, dq and dkv at both compute dtypes, 64 x 64
    tiles at D <= 128, the bf16 forward and dq 128 query rows a CTA at D =
    256, the f32 forward 128 rows a CTA at D <= 128) must lie inside the
    plane, overlap nowhere, and cover that region. The kernels skip the
    tiles above the diagonal and outside a window; those hold no consumed
    bit, so they are no gap. Inside the region the check is JAX's.
  * ``HOW_XLA``: one monolithic draw of the whole plane, as in JAX.

The persistent grids are sized by occupancy on the card; the walks are
proven for an H100 SXM (132 SMs: ``RESIDENT_CLUSTERS`` clusters of the
bf16 GEMM, ``PHILOX_CTAS_PER_SM`` CTAs a SM of the Philox kernel). All of
it is integer interval arithmetic on shapes: no kernel runs and nothing is
built, and no word or score element is enumerated.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import rules
from repro_torch.config.base import (
    CARRIED_DROPOUT_SITES,
    AttentionKind,
    ModelConfig,
)
from repro_torch.core import producer
from repro_torch.core.overlap import SALT_ATTN, SALT_EMBED, SALT_RESID
from repro_torch.core.schedule import DropoutSchedule
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import flash_attention_bwd as flash_bwd
from repro_torch.kernels import gemm_rng, philox
from repro_torch.kernels.gemm_rng import mask_emission_layout
from repro_torch.kernels.philox_common import (
    fold_layer_salt,
    shard_bh_intervals,
    shard_plane_windows,
)

# (step, r0, r1, c0, c1): rows [r0, r1) x cols [c0, c1) of the local
# packed plane written by grid step (or CTA) ``step`` (-1 = monolithic)
Block = Tuple[int, int, int, int, int]

# The GEMM+RNG kernels' CTA tiles (csrc/gemm_tc.cuh, gemm_fp8.cuh: 128 x
# 128; csrc/gemm_walk.cuh: 128 x 256 in clusters of two) and the plane's
# unit of the bf16 walk.
GEMM_TILE = 128
BF16_TILE_N = 256
BF16_CLUSTER = 2
BF16_UNIT = 32
# The persistent grids on an H100 SXM (132 SMs): the bf16 GEMM's resident
# clusters (repro_gemm_rng_bf16_clusters) and the Philox kernel's CTAs a
# SM at 7 rounds (repro_philox_mask_ctas_per_sm), of 256 threads.
H100_SMS = 132
RESIDENT_CLUSTERS = 66
PHILOX_CTAS_PER_SM = 4
PHILOX_THREADS = 256
PHILOX_WORDS = 4
# The flash kernels' tile (csrc/flash_common.cuh: BQ = BK = 64).
FLASH_TILE = flash.KERNEL_TILE

# launch-counter names of the host kernels each plan dtype can run (the
# f32 plan under bf16 compute runs the bf16 kernel; the e4m3 kernels have a
# bf16-C instance on the same grid)
_DENSE_HOSTS = {"f32": (gemm_rng.KERNEL, gemm_rng.KERNEL_BF16),
                "bf16": (gemm_rng.KERNEL_BF16,),
                "fp8": (gemm_rng.KERNEL_FP8, gemm_rng.KERNEL_FP8_BF16)}
_GROUPED_HOSTS = {"f32": (gemm_rng.KERNEL_GROUPED,
                          gemm_rng.KERNEL_GROUPED_BF16),
                  "bf16": (gemm_rng.KERNEL_GROUPED_BF16,),
                  "fp8": (gemm_rng.KERNEL_GROUPED_FP8,
                          gemm_rng.KERNEL_GROUPED_FP8_BF16)}
_BF16_HOSTS = (gemm_rng.KERNEL_BF16, gemm_rng.KERNEL_GROUPED_BF16)


@dataclasses.dataclass(frozen=True)
class ShardWindow:
    """One shard-local producer's tile of the global (B, H) mask plane,
    in the coordinates the kernels consume (philox_common.global_bh)."""
    bh_offset: int
    batch_local: int
    heads_local: int
    heads_global: int

    def intervals(self) -> Tuple[Tuple[int, int], ...]:
        return shard_bh_intervals(self.bh_offset, self.batch_local,
                                  self.heads_local, self.heads_global)


@dataclasses.dataclass(frozen=True)
class CtaRuns:
    """A GEMM+RNG kernel's split of an emission among its CTAs: the
    emission's ``total`` units of ``unit`` words, in the kernel's order
    (``unit`` 1: the layout's rectangles in block order, row-major inside
    a block; ``unit`` 32: the plane's rows cut into 32-word units), and
    each CTA's run [first, end) of them."""
    kernel: str
    unit: int
    total: int
    runs: Tuple[Tuple[int, int, int], ...]     # (cta, first, end)


@dataclasses.dataclass(frozen=True)
class StrideWalk:
    """The standalone Philox kernel's walk: ``groups`` groups of WORDS
    words (``groups_per_row`` a row), thread i of ``threads`` taking groups
    i, i + stride, i + 2 stride, ..."""
    kernel: str
    groups: int
    groups_per_row: int
    threads: int
    stride: int


@dataclasses.dataclass(frozen=True)
class TileWalk:
    """A flash kernel instance's replay tiles over ONE head's packed rows
    (sq32 of them by sk keys), the same for each of ``heads`` head rows of
    the local plane: (cta, r0, r1, c0, c1) for every tile it derives keep
    bits for. The region it must cover is the consumed one (causal,
    ``window`` > 0 for a LOCAL layer)."""
    kernel: str
    tiles: Tuple[Block, ...]
    sq32: int
    sk: int
    heads: int
    window: int = 0
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class MaskEmission:
    """One planned mask emission, resolved to counter space: identity
    (salt of the target layer), the shard windows it runs over, JAX's
    rectangles of the local packed plane (``blocks``: the fused hosts'
    layout and the monolithic tensor-op draw; the standalone and replay
    walks carry their own), and the kernels' walks (``walks``)."""
    producer_layer: int           # -1 = standalone bootstrap
    target_layer: int             # consumer whose salt the bits use
    salt: int
    site: str
    how: str
    windows: Tuple[ShardWindow, ...]
    blocks: Tuple[Block, ...]
    rows_valid: int               # local plane: b_loc * h_loc * sq32
    sk: int
    walks: Tuple = ()
    # plane never consumed: a tail emission past the last layer, or a
    # retained run-and-discard host on a replay-planned cell (the RNG still
    # draws, so tiling and salt are proven, but it does not count toward
    # the one-draw-per-consumer linkage)
    dropped: bool = False
    infeasible: bool = False      # planned fused, but the grid can't host

    def describe(self) -> str:
        src = ("bootstrap" if self.producer_layer < 0
               else f"L{self.producer_layer}")
        return (f"{src} -> L{self.target_layer} under {self.site} "
                f"how={self.how}")


# --------------------------------------------------------------------------
# the kernels' walks (plain integer mirrors of the CUDA code)
# --------------------------------------------------------------------------

def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def emit_share_runs(total: int, n_ctas: int) -> Tuple[Tuple[int, int, int],
                                                      ...]:
    """``gemm_emit.cuh::emit_share``: CTA c of n writes words [c per,
    min(total, c per + per)), per = ceil(total / n)."""
    per = _ceil_div(total, n_ctas)
    return tuple((c, c * per, min(total, c * per + per))
                 for c in range(n_ctas))


@functools.lru_cache(maxsize=None)
def unit_share_runs(units: int, n_ctas: int) -> Tuple[Tuple[int, int, int],
                                                      ...]:
    """``gemm_walk.cuh::share_of``: CTA c's run [first, end) of the
    plane's units, one of equal length a CTA (the last shorter or
    empty)."""
    per = _ceil_div(units, n_ctas)
    out = []
    for c in range(n_ctas):
        first = c * per
        end = first + per if first + per < units else units
        out.append((c, first if first < end else end, end))
    return tuple(out)


def bf16_grid_ctas(e: int, m: int, n: int,
                   resident_clusters: int = RESIDENT_CLUSTERS) -> int:
    """CTAs of the persistent bf16 GEMM+RNG launch (``gemm_bf16.cuh``):
    clusters of two on the cluster tiles, as many as are resident."""
    tiles_m = _ceil_div(m, GEMM_TILE)
    cluster_tiles = (e * _ceil_div(tiles_m, BF16_CLUSTER)
                     * _ceil_div(n, BF16_TILE_N))
    return BF16_CLUSTER * min(cluster_tiles, resident_clusters)


def tiled_grid_ctas(e: int, m: int, n: int) -> int:
    """CTAs of the f32 and e4m3 GEMM+RNG launches: one a 128 x 128 tile of
    each expert's product."""
    return e * _ceil_div(m, GEMM_TILE) * _ceil_div(n, GEMM_TILE)


@functools.lru_cache(maxsize=None)
def gemm_cta_runs(kernel: str, e: int, m: int, n: int, rows_valid: int,
                  sk: int, layout_words: int) -> CtaRuns:
    """The CTA split of a fused emission by kernel instance ``kernel`` on
    an E x (m, n) product whose layout covers ``layout_words`` words."""
    if kernel in _BF16_HOSTS:
        units = rows_valid * _ceil_div(sk, BF16_UNIT)
        return CtaRuns(kernel, BF16_UNIT, units,
                       unit_share_runs(units, bf16_grid_ctas(e, m, n)))
    return CtaRuns(kernel, 1, layout_words,
                   emit_share_runs(layout_words, tiled_grid_ctas(e, m, n)))


def philox_walk(rows_valid: int, sk: int, sms: int = H100_SMS,
                per_sm: int = PHILOX_CTAS_PER_SM) -> StrideWalk:
    """``philox_walk.cuh::launch_of``: as many CTAs as can run at once,
    fewer when the plane has fewer groups than their threads; each thread
    steps by the grid's threads."""
    gpr = _ceil_div(sk, PHILOX_WORDS)
    groups = rows_valid * gpr
    ctas = min(_ceil_div(groups, PHILOX_THREADS), sms * per_sm)
    threads = ctas * PHILOX_THREADS
    return StrideWalk(philox.KERNEL, groups, gpr, threads, threads)


def tile_runs(q_start: int, k_start: int, q_offset: int, causal: bool,
              local_window: int) -> bool:
    """``flash_common.cuh::tile_runs``: whether the (q-block, k-block) tile
    holds any valid score."""
    if not causal:
        return True
    q_lo = q_start + q_offset
    q_hi = q_start + FLASH_TILE - 1 + q_offset
    run = k_start <= q_hi
    if local_window > 0:
        run = run and (k_start + FLASH_TILE - 1 > q_lo - local_window)
    return run


def _run_of(hits: List[bool]) -> range:
    """The contiguous run the kernels walk: from the first hit, as many
    blocks as there are hits."""
    n = sum(hits)
    first = hits.index(True) if n else 0
    return range(first, first + n)


def _row_block_tiles(groups_per_cta: int, rowless_in_run: bool, sq: int,
                     sk: int, q_offset: int, causal: bool, window: int
                     ) -> Tuple[Block, ...]:
    """The forward's and dq's walk: a CTA of ``groups_per_cta`` 64-row
    groups walks the k-blocks holding a valid score for a row of any of
    its groups (the f32 forward's run also asks its last CTA's group that
    lies past SQ: ``rowless_in_run``), and each group with rows derives
    the bits of each."""
    t = FLASH_TILE
    rows_cta = t * groups_per_cta
    out = []
    for qi in range(_ceil_div(sq, rows_cta)):
        every = [qi * rows_cta + t * g for g in range(groups_per_cta)]
        starts = [q0 for q0 in every if q0 < sq]
        asked = every if rowless_in_run else starts
        run = _run_of([any(tile_runs(q0, ki * t, q_offset, causal, window)
                           for q0 in asked) for ki in range(sk // t)])
        for q0 in starts:
            for ki in run:
                out.append((qi, q0 // 32, (q0 + t) // 32, ki * t,
                            (ki + 1) * t))
    return tuple(out)


def _key_block_tiles(sq: int, sk: int, q_offset: int, causal: bool,
                     window: int) -> Tuple[Block, ...]:
    """The dkv walk: a CTA a 64-key block walks the q-blocks that hold a
    valid score of it (``flash_wide_map.cuh::q_run``)."""
    t = FLASH_TILE
    out = []
    for kb in range(sk // t):
        run = _run_of([tile_runs(qi * t, kb * t, q_offset, causal, window)
                       for qi in range(sq // t)])
        for qi in run:
            out.append((kb, qi * t // 32, (qi + 1) * t // 32, kb * t,
                        (kb + 1) * t))
    return tuple(out)


def _groups_per_cta(kind: str, f32: bool, head_dim: int) -> int:
    """64-row groups a CTA of a flash kernel instance: the f32 forward at
    D <= 128 runs two warpgroups of 64 rows a CTA (flash_fwd_sm90.cuh
    F32Ops); the bf16 forward and dq at D = 256 two consumers of 64 rows
    (flash_wide_map.cuh fwd_bf16_q_start); every other instance one."""
    wide = head_dim == flash.WIDE_HEAD_DIM
    if kind == "fwd":
        return 2 if (f32 and not wide) or (not f32 and wide) else 1
    if kind == "dq":
        return 2 if (not f32 and wide) else 1
    return 1


@functools.lru_cache(maxsize=None)
def flash_tile_walks(head_dim: int, seq: int, window: int, heads: int
                     ) -> Tuple[TileWalk, ...]:
    """The replay walks of the six flash kernel instances (forward, dq,
    dkv at f32 and bf16 compute) at ``head_dim`` over a (heads, seq, seq)
    causal plane, ``window`` > 0 for a LOCAL layer."""
    out = []
    for f32, names in ((True, (flash.KERNEL, flash_bwd.KERNEL_DQ,
                               flash_bwd.KERNEL_DKV)),
                       (False, (flash.KERNEL_BF16, flash_bwd.KERNEL_DQ_BF16,
                                flash_bwd.KERNEL_DKV_BF16))):
        for kind, name in zip(("fwd", "dq", "dkv"), names):
            if kind == "dkv":
                tiles = _key_block_tiles(seq, seq, 0, True, window)
            else:
                groups = _groups_per_cta(kind, f32, head_dim)
                # the f32 forward's run asks every warpgroup (rows or
                # not); the bf16 D = 256 walks ask those with rows
                tiles = _row_block_tiles(groups, f32, seq, seq, 0, True,
                                         window)
            out.append(TileWalk(flash.instance(name, head_dim), tiles,
                                seq // 32, seq, heads, window))
    return tuple(out)


def consumed_keys(r: int, sk: int, sq: int, window: int,
                  causal: bool = True) -> Tuple[int, int]:
    """[lo, hi): the keys that at least one query of packed row ``r``
    (queries 32 r .. 32 r + 31) attends (``flash_common.cuh::
    score_valid``; the query offset is sk - sq)."""
    if not causal:
        return 0, sk
    off = sk - sq
    lo = max(0, 32 * r + off - window + 1) if window > 0 else 0
    hi = min(sk, 32 * r + 31 + off + 1)
    return lo, max(lo, hi)


# --------------------------------------------------------------------------
# schedule -> emissions
# --------------------------------------------------------------------------

def _local_tile(cfg: ModelConfig, sched: DropoutSchedule,
                shard_local: bool) -> Tuple[int, int]:
    sh = sched.shard
    if shard_local and sh.policy_installed and sh.active:
        return sched.batch // sh.batch_shards, cfg.n_heads // sh.head_shards
    return sched.batch, cfg.n_heads


def _shard_windows(cfg: ModelConfig, sched: DropoutSchedule,
                   shard_local: bool) -> Tuple[ShardWindow, ...]:
    b, h = sched.batch, cfg.n_heads
    sh = sched.shard
    if not (shard_local and sh.active):
        return (ShardWindow(0, b, h, h),)
    return tuple(
        ShardWindow(off, b_loc, h_loc, h)
        for off, b_loc, h_loc in shard_plane_windows(
            b, h, sh.batch_shards, sh.head_shards))


def _fused(cfg: ModelConfig, sched: DropoutSchedule, site: str, layer: int,
           grouped: bool):
    """(blocks, rows_valid, walks) of a fused dense / grouped emission on
    the local plane: JAX's rectangles, judged on the JAX logical grid, and
    each host kernel's CTA split. blocks=None marks plan / kernel
    divergence."""
    seq = sched.seq
    sh = sched.shard
    b_loc, h_loc = _local_tile(cfg, sched, sh.policy_installed)
    rows_valid = b_loc * h_loc * (seq // 32)
    first_dense = cfg.moe.first_dense_layers if cfg.moe else 0
    block_is_moe = cfg.moe is not None and layer >= first_dense
    if grouped:
        g = producer.grouped_host_shapes(
            cfg, sched.batch, seq, batch_shards=sh.batch_shards,
            head_shards=sh.head_shards,
            seq_dispatch=sched.moe_seq_dispatch,
            moe_block=block_is_moe).get(site)
        if g is None:
            return None, rows_valid, ()
        e, m, kdim, n = g
        blocks = producer.pick_gemm_blocks(m, n, kdim)
        if blocks is None:
            return None, rows_valid, ()
        bm, bn, _ = blocks
        n_steps = e * (m // bm) * (n // bn)
        hosts = _GROUPED_HOSTS[sched.plan.gemm_dtype]
    else:
        dense_ffn = (True if (cfg.moe is not None and not block_is_moe
                              and site in ("ffn_up", "ffn_down"))
                     else None)
        gemm = producer.block_gemm_shapes(
            cfg, sched.batch, seq, dense_ffn=dense_ffn).get(site)
        if gemm is None:
            return None, rows_valid, ()
        e = 1
        m, n, kdim = (producer.shard_host_gemm(
            *gemm, sh.batch_shards, sh.head_shards)
            if sh.policy_installed and sh.active else gemm)
        blocks = producer.pick_gemm_blocks(m, n, kdim)
        if blocks is None:
            return None, rows_valid, ()
        bm, bn, _ = blocks
        n_steps = (m // bm) * (n // bn)
        hosts = _DENSE_HOSTS[sched.plan.gemm_dtype]
    layout = mask_emission_layout(
        n_steps, b_loc, h_loc, seq, seq,
        mask_block_cols=producer.mask_cols_cap(seq, seq))
    if layout is None:
        return None, rows_valid, ()
    rects = tuple(layout.blocks())
    words = sum((r1 - r0) * (c1 - c0) for _, r0, r1, c0, c1 in rects)
    walks = tuple(gemm_cta_runs(k, e, m, n, rows_valid, seq, words)
                  for k in hosts)
    return rects, rows_valid, walks


def _emission(cfg: ModelConfig, sched: DropoutSchedule, *,
              producer_layer: int, target_layer: int, site: str,
              how: str, shard_local: bool,
              cache: Dict, dropped: bool = False) -> MaskEmission:
    """Resolve one planned emission to counter space. ``cache`` shares
    walks across the (periodic) layers of one schedule."""
    kinds = cfg.layer_kinds()
    local = (how == producer.HOW_REPLAY and target_layer < cfg.n_layers
             and kinds[target_layer] == AttentionKind.LOCAL)
    window = cfg.local_window if local else 0
    key = (site, how, shard_local, window,
           cfg.moe is not None
           and max(producer_layer, 0) >= cfg.moe.first_dense_layers)
    if key not in cache:
        # the kernels run on the schedule's shard tile; the tensor-op
        # producer on the tile its assignment names (JAX's rule)
        b_loc, h_loc = _local_tile(
            cfg, sched, shard_local if how == producer.HOW_XLA else True)
        rows = b_loc * h_loc * (sched.seq // 32)
        walks: Tuple = ()
        blocks: Optional[Tuple[Block, ...]] = ()
        if how in (producer.HOW_GEMM, producer.HOW_GEMM_GROUPED):
            blocks, rows, walks = _fused(
                cfg, sched, site, max(producer_layer, 0),
                grouped=how == producer.HOW_GEMM_GROUPED)
        elif how == producer.HOW_STANDALONE:
            walks = (philox_walk(rows, sched.seq),)
        elif how == producer.HOW_REPLAY:
            walks = flash_tile_walks(cfg.head_dim, sched.seq, window,
                                     b_loc * h_loc)
        else:                      # HOW_XLA: one monolithic draw
            blocks = ((-1, 0, rows, 0, sched.seq),)
        cache[key] = (blocks, rows, walks)
    blocks, rows, walks = cache[key]
    return MaskEmission(
        producer_layer=producer_layer, target_layer=target_layer,
        salt=fold_layer_salt(target_layer, SALT_ATTN), site=site,
        how=how,
        windows=_shard_windows(cfg, sched, shard_local),
        blocks=blocks if blocks is not None else (),
        rows_valid=rows, sk=sched.seq, walks=walks,
        dropped=dropped or target_layer >= cfg.n_layers,
        infeasible=blocks is None)


def schedule_emissions(cfg: ModelConfig, sched: DropoutSchedule
                       ) -> Tuple[MaskEmission, ...]:
    """Enumerate every mask emission the schedule plans, resolved to
    counter space: JAX's enumeration, the port's walks. Pure shape / int
    arithmetic; nothing executes."""
    if not sched.active:
        return ()
    out: List[MaskEmission] = []
    cache: Dict = {}
    sh = sched.shard
    for a in sched.assignments:
        if a.consumes and a.how == producer.HOW_REPLAY:
            # replay-planned consumer: the flash kernels re-derive the
            # plane in-register from position-based counters; their walks
            # are this layer's only live draw
            out.append(_emission(
                cfg, sched, producer_layer=a.layer,
                target_layer=a.layer, site=a.site, how=a.how,
                shard_local=a.sharded, cache=cache))
            if a.host_how and a.site not in CARRIED_DROPOUT_SITES:
                # retained run-and-discard in-layer host (qkv): its RNG
                # still draws under the GEMM, the bits are discarded
                out.append(_emission(
                    cfg, sched, producer_layer=a.layer,
                    target_layer=a.layer, site=a.site, how=a.host_how,
                    shard_local=sh.policy_installed and sh.active,
                    cache=cache, dropped=True))
        elif a.consumes and a.site not in CARRIED_DROPOUT_SITES:
            # in-layer producer (xla / qkv) or the standalone bootstrap:
            # emits its own layer's mask
            out.append(_emission(
                cfg, sched,
                producer_layer=(-1 if a.producer < 0 else a.layer),
                target_layer=a.layer, site=a.site, how=a.how,
                shard_local=a.sharded, cache=cache))
        if a.emit_site is not None:
            # carried pipeline: this block hosts layer (a.layer +
            # emit_stride)'s mask under one of its GEMMs; a replay target
            # never reads it (a retained run-and-discard host: dropped)
            tgt = a.layer + a.emit_stride
            tgt_replay = (tgt < cfg.n_layers
                          and sched.assignments[tgt].how
                          == producer.HOW_REPLAY)
            out.append(_emission(
                cfg, sched, producer_layer=a.layer,
                target_layer=tgt, site=a.emit_site,
                how=a.emit_how,
                shard_local=(a.emit_how != producer.HOW_XLA
                             and sh.policy_installed and sh.active),
                cache=cache, dropped=tgt_replay))
    return tuple(out)


# --------------------------------------------------------------------------
# checks
# --------------------------------------------------------------------------

def _finding(rule: str, em: MaskEmission, msg: str) -> rules.Finding:
    return rules.Finding(rule, f"{em.describe()}: {msg}",
                         layer=em.producer_layer,
                         other_layer=em.target_layer)


def _check_plane_tiling(em: MaskEmission) -> List[rules.Finding]:
    """Exact-cover proof for one emission's rectangles of the local packed
    plane: every rectangle in bounds, pairwise disjoint (incremental sweep
    over row bands), and total area == plane area (JAX's check)."""
    plane = em.rows_valid * em.sk
    found: List[rules.Finding] = []
    area = 0
    add: Dict[int, List[Tuple[int, int, int, int]]] = {}
    rem: Dict[int, List[Tuple[int, int, int, int]]] = {}
    for s, r0, r1, c0, c1 in em.blocks:
        if r0 < 0 or c0 < 0 or r1 > em.rows_valid or c1 > em.sk \
                or r0 >= r1 or c0 >= c1:
            found.append(_finding(
                rules.EMISSION_GAP, em, f"grid step {s} writes rows "
                f"[{r0},{r1}) x cols [{c0},{c1}) outside the "
                f"{em.rows_valid}x{em.sk} packed plane"))
            continue
        area += (r1 - r0) * (c1 - c0)
        iv = (c0, c1, s, r0)
        add.setdefault(r0, []).append(iv)
        rem.setdefault(r1, []).append(iv)
    active: Dict[Tuple[int, int, int, int], bool] = {}
    for cut in sorted(set(add) | set(rem)):
        for iv in rem.get(cut, ()):
            active.pop(iv, None)
        for iv in add.get(cut, ()):
            active[iv] = True
        ivals = sorted(active)
        for (c0a, c1a, sa, _), (c0b, c1b, sb, _) in zip(ivals, ivals[1:]):
            if c1a > c0b:
                found.append(_finding(
                    rules.COUNTER_OVERLAP, em,
                    f"grid steps {sa} and {sb} both draw packed rows "
                    f"around {cut}, cols [{c0b},{min(c1a, c1b)}) -- "
                    "double draw"))
                return found          # one pair is enough evidence
    if not found and area < plane:
        found.append(_finding(
            rules.EMISSION_GAP, em,
            f"grid covers {area} of {plane} packed words -- "
            f"{plane - area} dead (never-drawn) mask bits"))
    return found


def _check_cta_runs(em: MaskEmission, w: CtaRuns) -> List[rules.Finding]:
    """The kernel's CTA runs partition its [0, total) units with no overlap
    and no gap, and those units are the emission's words: the layout's
    rectangles' words (unit 1), or the plane's rows cut into whole units
    (unit 32)."""
    found: List[rules.Finding] = []
    area = sum((r1 - r0) * (c1 - c0) for _, r0, r1, c0, c1 in em.blocks)
    if w.unit == 1:
        covers = w.total == area
    else:
        per_row = _ceil_div(em.sk, w.unit)
        covers = (w.total == em.rows_valid * per_row
                  and area == em.rows_valid * em.sk)
    if not covers:
        found.append(_finding(
            rules.EMISSION_GAP, em,
            f"{w.kernel} walks {w.total} units of {w.unit} words, which "
            f"are not the {em.rows_valid}x{em.sk} plane's {area} words"))
    pos = 0
    gap = overlap = None
    for cta, first, end in sorted(w.runs, key=lambda r: (r[1], r[2])):
        if first >= end:
            continue
        if first < pos and overlap is None:
            overlap = (cta, first, min(pos, end))
        elif first > pos and gap is None:
            gap = (pos, first)
        pos = max(pos, end)
    if pos < w.total and gap is None:
        gap = (pos, w.total)
    if overlap is not None:
        cta, lo, hi = overlap
        found.append(_finding(
            rules.COUNTER_OVERLAP, em,
            f"{w.kernel}: CTA {cta} re-draws units [{lo},{hi}) of "
            f"{w.unit} words that an earlier CTA's run draws -- double "
            "draw"))
    if gap is not None:
        found.append(_finding(
            rules.EMISSION_GAP, em,
            f"{w.kernel}: no CTA's run draws units [{gap[0]},{gap[1]}) of "
            f"{w.unit} words -- dead mask bits"))
    return found


def _check_stride_walk(em: MaskEmission, w: StrideWalk
                       ) -> List[rules.Finding]:
    """Threads i in [0, S) taking groups i + j T (T the stride) cover
    [0, G) once iff (closed form over the residues mod T): no group T
    below G is taken twice (T >= S, or T >= G), and none is never taken
    (S >= G, or T <= S). Groups are WORDS words of a row, the last one of
    a row short, and ``groups_per_row`` of them tile a row."""
    found: List[rules.Finding] = []
    gpr = w.groups_per_row
    if not (gpr * PHILOX_WORDS >= em.sk > (gpr - 1) * PHILOX_WORDS
            and w.groups == em.rows_valid * gpr):
        found.append(_finding(
            rules.EMISSION_GAP, em,
            f"{w.kernel}'s {w.groups} groups of {PHILOX_WORDS} words "
            f"({gpr} a row) are not the {em.rows_valid}x{em.sk} plane"))
    s, t, g = w.threads, w.stride, w.groups
    if s <= 0 or t <= 0:
        found.append(_finding(
            rules.EMISSION_GAP, em,
            f"{w.kernel}: a grid of {s} threads stepping by {t} draws "
            "nothing"))
        return found
    if t < s and t < g:
        found.append(_finding(
            rules.COUNTER_OVERLAP, em,
            f"{w.kernel}: threads {t} and 0 both draw group {t} (stride "
            f"{t} < {s} threads) -- double draw"))
    if s < g and t > s:
        found.append(_finding(
            rules.EMISSION_GAP, em,
            f"{w.kernel}: no thread draws group {s} (stride {t} > {s} "
            f"threads) -- dead mask bits"))
    return found


def _check_tile_walk(em: MaskEmission, w: TileWalk) -> List[rules.Finding]:
    """A flash kernel's replay tiles over one head's packed rows: in the
    plane, pairwise disjoint (a sweep over row bands), and covering the
    consumed region row by row; the heads repeat the pattern at a stride
    of sq32 rows, so the local plane is proven once ``heads`` x sq32 is
    its height."""
    found: List[rules.Finding] = []
    if w.heads * w.sq32 != em.rows_valid or w.sk != em.sk:
        found.append(_finding(
            rules.EMISSION_GAP, em,
            f"{w.kernel} replays {w.heads} heads of {w.sq32}x{w.sk} "
            f"packed words, not the {em.rows_valid}x{em.sk} plane"))
    add: Dict[int, List[Tuple[int, int, int]]] = {}
    rem: Dict[int, List[Tuple[int, int, int]]] = {}
    for cta, r0, r1, c0, c1 in w.tiles:
        if r0 < 0 or c0 < 0 or r1 > w.sq32 or c1 > w.sk or r0 >= r1 \
                or c0 >= c1:
            found.append(_finding(
                rules.EMISSION_GAP, em,
                f"{w.kernel}: CTA {cta} replays rows [{r0},{r1}) x cols "
                f"[{c0},{c1}) outside a head's {w.sq32}x{w.sk} packed "
                "rows"))
            continue
        iv = (c0, c1, cta)
        add.setdefault(r0, []).append(iv)
        rem.setdefault(r1, []).append(iv)
    active: Dict[Tuple[int, int, int], int] = {}
    overlap = gap = None
    cuts = sorted(set(add) | set(rem) | {0, w.sq32})
    for cut, nxt in zip(cuts, cuts[1:]):
        for iv in rem.get(cut, ()):
            active[iv] -= 1
            if not active[iv]:
                del active[iv]
        for iv in add.get(cut, ()):
            active[iv] = active.get(iv, 0) + 1
        ivals = sorted(iv for iv, n in active.items() for _ in range(n))
        runs: List[List[int]] = []
        for c0, c1, cta in ivals:
            if runs and c0 < runs[-1][1] and overlap is None:
                overlap = (cut, c0, min(runs[-1][1], c1))
            if runs and c0 <= runs[-1][1]:
                runs[-1][1] = max(runs[-1][1], c1)
            else:
                runs.append([c0, c1])
        for r in range(cut, nxt):
            lo, hi = consumed_keys(r, w.sk, 32 * w.sq32, w.window,
                                   w.causal)
            if hi > lo and gap is None and not any(
                    a <= lo and hi <= b for a, b in runs):
                gap = (r, lo, hi)
    if overlap is not None:
        r, lo, hi = overlap
        found.append(_finding(
            rules.COUNTER_OVERLAP, em,
            f"{w.kernel}: two tiles replay packed row {r}, cols "
            f"[{lo},{hi}) of a head -- double draw"))
    if gap is not None:
        r, lo, hi = gap
        found.append(_finding(
            rules.EMISSION_GAP, em,
            f"{w.kernel}: packed row {r} of a head needs keys "
            f"[{lo},{hi}) and no visited tile covers them"))
    return found


_WALK_CHECKS = {CtaRuns: _check_cta_runs, StrideWalk: _check_stride_walk,
                TileWalk: _check_tile_walk}
# walks proven clean, by identity and by what the checks read of the
# emission (its plane's height and width, the area of its rectangles): the
# functions that make walks are cached, so a walk's proof is shared by
# every cell that plans it against the same plane; the walk is kept alive
# here, so its id is never reused
_PROVEN: Dict[int, Tuple[object, set]] = {}


def _check_walk(em: MaskEmission, w) -> List[rules.Finding]:
    plane = (em.rows_valid, em.sk,
             sum((r1 - r0) * (c1 - c0) for _, r0, r1, c0, c1 in em.blocks))
    proven = _PROVEN.get(id(w))
    if proven is not None and proven[0] is w and plane in proven[1]:
        return []
    found = _WALK_CHECKS[type(w)](em, w)
    if not found:
        _PROVEN.setdefault(id(w), (w, set()))[1].add(plane)
    return found


def _check_shard_windows(em: MaskEmission, batch: int, n_heads: int
                         ) -> List[rules.Finding]:
    """The emission's shard windows must exactly tile the global (B, H)
    counter plane: merge every window's global_bh intervals and demand
    one gapless, overlap-free run [0, B*H)."""
    ivals = sorted(iv for w in em.windows for iv in w.intervals())
    plane = batch * n_heads
    pos = 0
    for lo, hi in ivals:
        if lo < pos:
            return [_finding(
                rules.SHARD_WINDOW_MISMATCH, em,
                f"shard windows double-draw global counter rows "
                f"[{lo},{min(pos, hi)}) of the (B={batch}, H={n_heads}) "
                "plane")]
        if lo > pos:
            return [_finding(
                rules.SHARD_WINDOW_MISMATCH, em,
                f"no shard window draws global counter rows [{pos},{lo}) "
                f"of the (B={batch}, H={n_heads}) plane")]
        pos = hi
    if pos != plane:
        return [_finding(
            rules.SHARD_WINDOW_MISMATCH, em,
            f"shard windows cover [0,{pos}) of the [0,{plane}) global "
            "(b*H+h) counter range")]
    return []


def _check_consumer_linkage(sched: DropoutSchedule,
                            emissions: Tuple[MaskEmission, ...]
                            ) -> List[rules.Finding]:
    found: List[rules.Finding] = []
    by_target: Dict[int, List[MaskEmission]] = {}
    for em in emissions:
        if em.dropped:
            # run-and-discard plane: the RNG draws but nothing consumes
            # the bits, so it is neither a live draw nor a stride target
            continue
        by_target.setdefault(em.target_layer, []).append(em)
    for a in sched.assignments:
        if not a.consumes:
            # a non-consuming layer must not be the target of a live
            # emission (a stride bug pointing a pipeline at a mixer)
            for em in by_target.get(a.layer, ()):
                found.append(rules.Finding(
                    rules.STRIDE_MISMATCH,
                    f"{em.describe()}: target layer L{a.layer} "
                    f"({a.kind}) consumes no attention-score mask",
                    layer=em.producer_layer, other_layer=a.layer))
            continue
        ems = by_target.get(a.layer, [])
        if not ems:
            found.append(rules.Finding(
                rules.EMISSION_GAP,
                f"L{a.layer} consumes a mask but no assignment emits "
                f"for it (expected producer "
                + ("bootstrap" if a.producer < 0 else f"L{a.producer}")
                + ")", layer=a.layer))
        elif len(ems) > 1:
            found.append(rules.Finding(
                rules.COUNTER_OVERLAP,
                f"L{a.layer}'s mask is drawn {len(ems)} times ("
                + "; ".join(em.describe() for em in ems)
                + ") -- double draw of one counter window",
                layer=a.layer, other_layer=ems[0].producer_layer))
        if a.site in CARRIED_DROPOUT_SITES and a.producer >= 0:
            p = sched.assignments[a.producer]
            if p.emit_site is None:
                # a replay consumer tolerates a cleared pipeline (it
                # re-derives in-register); a materialized one does not
                if a.how != producer.HOW_REPLAY:
                    found.append(rules.Finding(
                        rules.STRIDE_MISMATCH,
                        f"L{a.layer} consumes from L{a.producer} but "
                        "that block's emission does not exist",
                        layer=a.producer, other_layer=a.layer))
            elif p.layer + p.emit_stride != a.layer:
                # applies under replay too: a retained run-and-discard
                # host is contract-identical only if its pipeline still
                # lands on the consumer it was planned for
                found.append(rules.Finding(
                    rules.STRIDE_MISMATCH,
                    f"L{a.layer} consumes from L{a.producer} but that "
                    f"block's emission targets "
                    f"L{p.layer + p.emit_stride}",
                    layer=a.producer, other_layer=a.layer))
    return found


def _check_salts(cfg: ModelConfig) -> List[rules.Finding]:
    seen: Dict[int, Tuple[int, str]] = {}
    found: List[rules.Finding] = []
    streams = (("attn", SALT_ATTN), ("resid", SALT_RESID),
               ("embed", SALT_EMBED))
    for layer in range(cfg.n_layers):
        for name, stream in streams:
            s = fold_layer_salt(layer, stream)
            if s in seen:
                o_layer, o_name = seen[s]
                found.append(rules.Finding(
                    rules.SALT_COLLISION,
                    f"salt({layer}, {name}) == salt({o_layer}, "
                    f"{o_name}) == {s:#010x}: two RNG streams share "
                    "one Philox counter identity",
                    layer=layer, other_layer=o_layer))
            else:
                seen[s] = (layer, name)
    return found


def check_emissions(cfg: ModelConfig, sched: DropoutSchedule,
                    emissions: Tuple[MaskEmission, ...]
                    ) -> List[rules.Finding]:
    """Run every counter-space check over derived emissions."""
    found: List[rules.Finding] = []
    # rectangles are shared across a schedule's (periodic) layers: prove
    # each distinct plane layout once
    clean_planes: set = set()
    for em in emissions:
        if em.infeasible:
            found.append(_finding(
                rules.REGION_MISMATCH, em,
                "planned as a fused host but the GEMM grid cannot host "
                "the mask (Region 3 at run time) -- schedule/kernel "
                "divergence"))
            continue
        if em.blocks:
            plane_key = (id(em.blocks), em.rows_valid, em.sk)
            if plane_key not in clean_planes:
                tiling = _check_plane_tiling(em)
                found.extend(tiling)
                if not tiling:
                    clean_planes.add(plane_key)
        for w in em.walks:
            found.extend(_check_walk(em, w))
        found.extend(_check_shard_windows(em, sched.batch, cfg.n_heads))
    found.extend(_check_consumer_linkage(sched, emissions))
    found.extend(_check_salts(cfg))
    return found


def analyze_schedule(cfg: ModelConfig, sched: DropoutSchedule,
                     cell: str = "") -> rules.Report:
    """Counter-space verdict for one compiled schedule."""
    emissions = schedule_emissions(cfg, sched)
    findings = check_emissions(cfg, sched, emissions)
    return rules.Report(
        cell=cell or f"{sched.model} site={sched.plan.site} "
                     f"dtype={sched.plan.gemm_dtype}",
        findings=tuple(findings), checked_emissions=len(emissions))


# --------------------------------------------------------------------------
# mutation harness (tests + `lint --mutate`)
# --------------------------------------------------------------------------

def _first_with(emissions, pred, what: str) -> int:
    for i, em in enumerate(emissions):
        if pred(em):
            return i
    raise ValueError(f"{what}")


def _replace_walk(em: MaskEmission, old, new) -> MaskEmission:
    return dataclasses.replace(
        em, walks=tuple(new if w is old else w for w in em.walks))


def corrupt_emissions(emissions: Tuple[MaskEmission, ...], kind: str
                      ) -> Tuple[MaskEmission, ...]:
    """Inject one counter-space corruption into a derived emission set --
    the negative half of the analyzer's test surface. JAX's kinds:
      "counter-overlap" -- one grid step re-draws another's rectangle
      "emission-gap"    -- one grid step's rectangle is never drawn
      "shard-window"    -- one producer's bh_offset is off by one
      "reshard-window"  -- a resharded restore re-derives a window from
                           the old topology: one shard's window replaced
                           by a copy of another's
      "replay-counter-drift" -- a replay consumer re-derives from a
                           drifted counter base (bh_offset off by one),
                           beside the planned derivation
    and the port's, one for each CUDA walk:
      "cta-run-shift"   -- a GEMM+RNG kernel's CTA run shifted by one word
      "philox-stride"   -- the standalone Philox walk's group stride off
                           by one
      "replay-tile-row" -- a flash kernel's replay tile one packed row off
    """
    if not emissions:
        raise ValueError("no emissions to corrupt (inert schedule)")
    idx = max(range(len(emissions)),
              key=lambda i: len(emissions[i].blocks))
    em = emissions[idx]
    if kind == "counter-overlap":
        s, r0, r1, c0, c1 = em.blocks[0]
        mutated = dataclasses.replace(
            em, blocks=em.blocks + ((len(em.blocks), r0, r1, c0, c1),))
    elif kind == "emission-gap":
        mutated = dataclasses.replace(em, blocks=em.blocks[:-1])
    elif kind == "shard-window":
        w = em.windows[0]
        mutated = dataclasses.replace(
            em, windows=(dataclasses.replace(
                w, bh_offset=w.bh_offset + 1),) + em.windows[1:])
    elif kind == "reshard-window":
        idx = _first_with(
            emissions, lambda e: len(e.windows) >= 2,
            "reshard-window needs a sharded emission (>= 2 shard "
            "windows); compile the schedule on a multi-shard topology "
            "first")
        em = emissions[idx]
        mutated = dataclasses.replace(
            em, windows=(em.windows[0], em.windows[0]) + em.windows[2:])
    elif kind == "replay-counter-drift":
        idx = _first_with(
            emissions, lambda e: e.how == producer.HOW_REPLAY,
            "replay-counter-drift needs a replay-planned cell "
            "(HOW_REPLAY consumption); compile with attn_impl='pallas' "
            "on a replay-feasible schedule first")
        em = emissions[idx]
        w = em.windows[0]
        drifted = dataclasses.replace(
            em, windows=(dataclasses.replace(
                w, bh_offset=w.bh_offset + 1),) + em.windows[1:])
        return emissions[:idx] + (em, drifted) + emissions[idx + 1:]
    elif kind == "cta-run-shift":
        idx = _first_with(
            emissions, lambda e: any(isinstance(w, CtaRuns)
                                     for w in e.walks),
            "cta-run-shift needs a fused GEMM+RNG host emission")
        em = emissions[idx]
        w = next(w for w in em.walks if isinstance(w, CtaRuns))
        runs = list(w.runs)
        mid = next(i for i in range(len(runs) // 2, len(runs))
                   if runs[i][1] < runs[i][2] < w.total)
        cta, first, end = runs[mid]
        runs[mid] = (cta, first + 1, end + 1)
        mutated = _replace_walk(em, w, dataclasses.replace(
            w, runs=tuple(runs)))
    elif kind == "philox-stride":
        idx = _first_with(
            emissions, lambda e: any(isinstance(w, StrideWalk)
                                     for w in e.walks),
            "philox-stride needs a standalone (Philox kernel) emission; "
            "compile a carried site with attn_replay='off' first")
        em = emissions[idx]
        w = next(w for w in em.walks if isinstance(w, StrideWalk))
        mutated = _replace_walk(em, w, dataclasses.replace(
            w, stride=w.stride + 1))
    elif kind == "replay-tile-row":
        idx = _first_with(
            emissions, lambda e: any(isinstance(w, TileWalk)
                                     for w in e.walks),
            "replay-tile-row needs a replay-planned cell")
        em = emissions[idx]
        w = next(w for w in em.walks if isinstance(w, TileWalk))
        cta, r0, r1, c0, c1 = w.tiles[0]
        mutated = _replace_walk(em, w, dataclasses.replace(
            w, tiles=((cta, r0 + 1, r1 + 1, c0, c1),) + w.tiles[1:]))
    else:
        raise ValueError(f"unknown corruption {kind!r}")
    return emissions[:idx] + (mutated,) + emissions[idx + 1:]


def corrupt_schedule_stride(sched: DropoutSchedule) -> DropoutSchedule:
    """Corrupt the first emitting HostAssignment's ``emit_stride`` (the
    wrong-stride pipeline bug the linter must catch)."""
    asgs = list(sched.assignments)
    for i, a in enumerate(asgs):
        if a.emit_site is not None:
            asgs[i] = dataclasses.replace(a,
                                          emit_stride=a.emit_stride + 1)
            return dataclasses.replace(sched, assignments=tuple(asgs))
    raise ValueError("schedule has no emitting assignment to corrupt")
