"""Producer-site mask executors: the physical producers the compiled
``DropoutSchedule`` (core/schedule.py) tags each layer's mask with.

  "gemm_rng"         -- inside the fused GEMM+RNG kernel
                        (kernels/gemm_rng.py: csrc/gemm_rng.cu for f32
                        operands, csrc/gemm_rng_bf16.cu for bf16 ones --
                        gemm_dtype="bf16", or bf16 activations --,
                        csrc/gemm_rng_fp8.cu for the per-tile-scaled e4m3
                        host of gemm_dtype="fp8")
  "gemm_rng_grouped" -- inside the grouped GEMM+RNG kernel (per-expert
                        products: a MoE block's expert einsum, or E=1 for
                        the RWKV channel-mix key / value GEMM;
                        csrc/gemm_rng_grouped.cu in f32,
                        csrc/gemm_rng_grouped_bf16.cu in bf16,
                        csrc/gemm_rng_grouped_fp8.cu for fp8)
  "standalone"       -- the standalone Philox kernel (kernels/philox.py):
                        the paper's Region 3, where the GEMM cannot host
                        the RNG
  "xla"              -- the plain tensor-op producer (core/dropout_rng.py;
                        the only producer of the 8-bit scheme)
  "replay"           -- no plane at all: the flash-attention kernels
                        re-derive each tile's keep bits from the same
                        position-based counters; a GEMM host is kept
                        run-and-discard (``HostAssignment.host_how``)

Every producer is bit-identical for the same (seed, salt, layer, step).
The capability predicates and shape helpers are the JAX package's, so the
port plans the same producer for the same cell. The host GEMM sits in the
consuming layer (site "qkv") or, for the carried sites, in the previous
attention block: its out-projection ("prev_gemm", models/attention.py) or
an FFN GEMM ("ffn_up" / "ffn_down", ``FFNHost`` -> models/layers.py for
dense and RWKV channel-mix FFNs, models/moe.py for MoE expert FFNs).

With a sharding policy the kernel producers run SHARD-LOCAL inside
``compat.shard_map``: each rank makes its (b_loc, h_loc) tile of the plane
under its slice of the host GEMM, with the plane's global head count and
its tile's (b, h) offset (``heads_global`` / ``bh_offset``) in the
counters, so its bits are the global plane's slice exactly and no plane
crosses a collective.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config.base import FFNKind, ModelConfig
from repro_torch.core import dropout_rng
from repro_torch.core.overlap import DropoutPlan
from repro_torch.device import DeviceLike
from repro_torch.kernels import ops, quant
from repro_torch.kernels.gemm_rng import mask_layout_feasible

HOW_GEMM = "gemm_rng"
HOW_GEMM_GROUPED = "gemm_rng_grouped"
HOW_STANDALONE = "standalone"
HOW_XLA = "xla"
HOW_REPLAY = "replay"

# the JAX package's model-path GEMM block caps (its logical emission grid)
_BLOCK_M_CAP = 256
_BLOCK_N_CAP = 256
_BLOCK_K_CAP = 512
# the fused kernels' mask-column block (JAX gemm_rng.py mask_block_cols)
_MASK_COLS_CAP = 2048
# the TPU standalone philox kernel's column block
_PHILOX_COLS_CAP = 512


def _largest_divisor(dim: int, cap: int) -> int:
    for c in range(min(cap, dim), 0, -1):
        if dim % c == 0:
            return c
    return 1


_DTYPE_BYTES = {"f32": 4, "bf16": 2, "fp8": 1}


def _tuned_tables():
    """The tuned-table module (``repro_torch.tune.tables``), imported on
    first use: with no table installed every hook returns the shipped
    default."""
    from repro_torch.tune import tables
    return tables


def mask_cols_cap(sq: int, sk: int) -> int:
    """The fused kernels' emission column block for this plane: the active
    tuned table's (proven) choice, else the shipped default. Planner
    feasibility, the launched kernel's layout and the verifier's emission
    walk all resolve through this function."""
    return _tuned_tables().active_mask_cols(sq, sk, default=_MASK_COLS_CAP)


def pick_gemm_blocks(m: int, n: int, k: int
                     ) -> Optional[Tuple[int, int, int]]:
    """The logical block shape of a model-path fused GEMM, or None when
    the operand shapes do not tile cleanly (the caller keeps the plain
    GEMM and the tensor-op producer). The emission layout is judged on the
    grid this gives (and the e4m3 hosts' scale tiles are these blocks). An
    installed tuned table overrides the answer for the exact shapes it
    carries a proven entry for; the schedule compiler, the kernels'
    wrappers and ``repro_torch.analysis`` all resolve through here."""
    tuned = _tuned_tables().active_blocks(m, n, k)
    if tuned is not None:
        return tuned
    bm = _largest_divisor(m, _BLOCK_M_CAP)
    bn = _largest_divisor(n, _BLOCK_N_CAP)
    bk = _largest_divisor(k, _BLOCK_K_CAP)
    if bm % 8 or bn % 8 or bk % 8:
        return None
    return bm, bn, bk


def shard_host_gemm(m: int, n: int, k: int, batch_shards: int = 1,
                    head_shards: int = 1) -> Tuple[int, int, int]:
    """Per-shard (m_loc, n_loc, k) of a dense host GEMM under the mask
    plane's shard layout (the JAX package's function): rows follow the
    batch shards, columns the head shards; a dim that does not divide
    stays global. The schedule compiler and the counter layer
    (``analysis/counters.py``) derive a planned shard's grid from it."""
    m_loc = m // batch_shards if batch_shards > 1 and m % batch_shards == 0 \
        else m
    n_loc = n // head_shards if head_shards > 1 and n % head_shards == 0 \
        else n
    return m_loc, n_loc, k


def mask_kernel_unsupported_reason(plan: DropoutPlan, sq: int, sk: int,
                                   fused: bool = True) -> Optional[str]:
    """Why the TPU mask producers cannot represent this plan/shape — None
    when they can. Kept verbatim from the JAX package, whose schedule
    planning quotes these reasons: the Pallas kernels implement the 32-bit
    Philox scheme only, need 32-packable query rows, and tile the mask
    columns in 512-column blocks; the GEMM-fused hosts (``fused=True``)
    additionally partition the mask in 2048-column blocks. The port's
    standalone CUDA kernel has no column tiling, so its producer asks only
    for 32-bit planes (``standalone_packed_mask``)."""
    if plan.cfg.philox_bits != 32:
        return f"philox_bits={plan.cfg.philox_bits} (XLA-only scheme)"
    if sq % 32:
        return f"sq={sq} not 32-packable"
    sq32 = sq // 32
    if sq32 % min(8, sq32):
        return f"sq32={sq32} breaks the packed-row tiling"
    if sk % min(_PHILOX_COLS_CAP, sk):
        return f"sk={sk} breaks the {_PHILOX_COLS_CAP}-column tiling"
    cols = mask_cols_cap(sq, sk)
    if fused and sk % min(cols, sk):
        return f"sk={sk} breaks the {cols}-column mask blocks"
    return None


# --------------------------------------------------------------------------
# shard-local execution context
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardExec:
    """Live mesh context for shard-local producers, rebuilt from the
    installed ShardingPolicy at execute time (the compiled schedule carries
    only the hashable ShardInfo)."""
    mesh: Any
    batch_axes: Tuple[str, ...]
    head_axes: Tuple[str, ...]
    batch_shards: int
    head_shards: int

    def _spec_axes(self, axes: Tuple[str, ...]):
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]

    @property
    def b_spec(self):
        return self._spec_axes(self.batch_axes)

    @property
    def h_spec(self):
        return self._spec_axes(self.head_axes)


def shard_exec(policy, batch: int, n_heads: int) -> Optional[ShardExec]:
    """Shard-local context for a (batch, n_heads) plane under ``policy``,
    or None when no mesh axis divides either dim (the kernel then runs on
    the replicated tensors, as GSPMD replicates it in JAX)."""
    if policy is None:
        return None
    from repro_torch.distributed.sharding import mask_plane_shards
    (b_axes, nb), (h_axes, nh) = mask_plane_shards(policy, batch, n_heads)
    if nb * nh == 1:
        return None
    return ShardExec(mesh=policy.mesh, batch_axes=b_axes, head_axes=h_axes,
                     batch_shards=nb, head_shards=nh)


def _flat_axis_index(axes: Tuple[str, ...]) -> int:
    """This rank's flattened (row-major) index along ``axes`` (inside a
    shard_map body)."""
    from repro_torch.compat import axis_index
    return axis_index(axes) if axes else 0


def shard_mask_tile(shard: Optional[ShardExec], batch: int, n_heads: int,
                    sq: int, sk: int):
    """This rank's tile of the (batch, n_heads) plane -- callable only
    inside a shard_map body over ``shard.mesh``. Returns (local plane
    shape, heads_global, bh_offset) for the kernels' global-position
    counters; with ``shard`` None the whole plane ((batch, n_heads, sq,
    sk), 0, 0)."""
    if shard is None:
        return (batch, n_heads, sq, sk), 0, 0
    b_loc = batch // shard.batch_shards
    h_loc = n_heads // shard.head_shards
    b0 = _flat_axis_index(shard.batch_axes) * b_loc
    h0 = _flat_axis_index(shard.head_axes) * h_loc
    return (b_loc, h_loc, sq, sk), n_heads, b0 * n_heads + h0


def _plane_spec(shard: ShardExec):
    from repro_torch.compat import P
    return P(shard.b_spec, shard.h_spec, None, None)


def standalone_packed_mask(plan: DropoutPlan, batch: int, n_heads: int,
                           sq: int, sk: int, layer_idx, step,
                           use_kernel: bool = True, policy=None,
                           device: DeviceLike = None) -> torch.Tensor:
    """Packed (B, H, SQ//32, SK) int32 mask from a standalone producer: the
    Philox kernel for 32-bit planes when ``use_kernel`` (its plain version
    on the CPU), else the plain tensor-op producer. Same bits either way.
    Used for the Region-3 remainder and to bootstrap the first consumer of
    a carried-site pipeline (no producer GEMM precedes it); the schedule's
    planned ``how`` decides ``use_kernel``. With a ``policy`` whose mesh
    splits the plane, the kernel runs shard-local (each rank its (b, h)
    tile) and the plane comes back a DTensor."""
    seed = plan.step_seed(step)
    salt = plan.salt(layer_idx)
    dev = device if policy is None or device is not None else \
        torch.device(policy.mesh.device_type)
    if use_kernel and plan.cfg.philox_bits == 32:
        shard = shard_exec(policy, batch, n_heads)
        if shard is None:
            return ops.dropout_mask(batch, n_heads, sq, sk, plan.cfg.p,
                                    seed, salt, plan.cfg.philox_rounds,
                                    device=dev)
        from repro_torch.compat import shard_map

        def body():
            (b_loc, h_loc, _sq, _sk), hg, off = shard_mask_tile(
                shard, batch, n_heads, sq, sk)
            return ops.dropout_mask(b_loc, h_loc, sq, sk, plan.cfg.p, seed,
                                    salt, plan.cfg.philox_rounds,
                                    heads_global=hg, bh_offset=off,
                                    device=dev)

        return shard_map(body, mesh=shard.mesh, in_specs=(),
                         out_specs=_plane_spec(shard))()
    return dropout_rng.packed_mask(
        batch, n_heads, sq, sk, plan.cfg.p, seed, salt,
        plan.cfg.philox_rounds, plan.cfg.philox_bits, device=dev)


def replay_unsupported_reason(plan: DropoutPlan, sq: int, sk: int,
                              attn_impl: str = "pallas") -> Optional[str]:
    """Why the schedule does not plan counter replay (mode="replay") for
    this plan, None when it does -- the JAX package's rule, verbatim, so
    the port plans what JAX plans. Its 128-tileable gate is the TPU grid's:
    at a sequence the CUDA kernels take (a multiple of 64) that it refuses,
    the plan is premask, and the flash kernels run it all the same."""
    if plan.cfg.attn_replay == "off":
        return "disabled by plan (attn_replay=off)"
    if attn_impl != "pallas":
        return "impl != pallas (no in-kernel counter replay)"
    if plan.cfg.philox_bits != 32:
        return f"philox_bits={plan.cfg.philox_bits} (XLA-only scheme)"
    if sq % 128 or sk % 128:
        return f"seq ({sq}, {sk}) not 128-tileable for the flash kernels"
    return None


def _host_call(gemm_dtype: str, fn, fp8_fn, a: torch.Tensor,
               b: torch.Tensor, **kw):
    """One fused host launch in the plan's dtype, cast as the JAX package
    casts (``_fused_gemm_call`` / ``grouped_gemm_seeded``): "fp8" runs the
    per-tile-scaled e4m3 kernel ``fp8_fn`` on the operands as they are (C
    in their dtype); "bf16" runs ``fn`` on bf16 operands and returns C in
    ``a``'s dtype; "f32" runs ``fn`` -- the kernel of the operands' own
    dtype: bf16 activations and weights (bf16 compute) take the bf16
    kernel as they are, as JAX's kernel does. Returns (y, plane or
    None)."""
    if gemm_dtype == "fp8":
        if not quant.have_fp8():
            raise NotImplementedError(
                "gemm_dtype='fp8' needs torch.float8_e4m3fn, which this "
                "torch build lacks")
        return fp8_fn(a, b, **kw)
    bf16 = gemm_dtype == "bf16"
    y, mask = fn(a.to(torch.bfloat16) if bf16 else a,
                 b.to(torch.bfloat16) if bf16 else b, **kw)
    return (y.to(a.dtype) if bf16 else y), mask


def _fused_gemm_call(x2d: torch.Tensor, w2d: torch.Tensor,
                     plan: DropoutPlan, mask_shape, seed, salt,
                     blocks: Tuple[int, int, int], gemm_dtype: str,
                     heads_global: int = 0, bh_offset=0):
    """One fused GEMM+RNG launch in the plan's host dtype (``_host_call``),
    on a shard's tile when ``heads_global`` / ``bh_offset`` say so.
    Returns (y2d, plane or None)."""
    batch, n_heads, sq, sk = mask_shape
    bm, bn, bk = blocks
    return _host_call(
        gemm_dtype, ops.fused_qkv_gemm_rng, ops.fused_gemm_rng_fp8, x2d, w2d,
        mask_batch=batch, mask_heads=n_heads, mask_sq=sq, mask_sk=sk,
        p=plan.cfg.p, seed=seed, salt=salt, rounds=plan.cfg.philox_rounds,
        block_m=bm, block_n=bn, block_k=bk,
        mask_block_cols=mask_cols_cap(sq, sk), heads_global=heads_global,
        bh_offset=bh_offset)


def gemm_with_mask(x2d: torch.Tensor, w2d: torch.Tensor, plan: DropoutPlan,
                   mask_shape: Tuple[int, int, int, int], layer_idx, step,
                   how: str, policy=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y = x2d @ w2d with the packed plane for ``mask_shape`` = (B, H, SQ,
    SK) made by the schedule's planned producer ``how``: HOW_XLA (the plain
    GEMM and the tensor-op producer), HOW_GEMM (the fused GEMM+RNG kernel)
    or HOW_STANDALONE (Region 3: the same kernel with emission off, then
    the standalone Philox kernel). Runs exactly that producer, and raises
    where the kernel's own layout check disagrees with the plan. With a
    ``policy`` the kernel runs shard-local (``_gemm_with_mask_sharded``),
    or on the replicated tensors when no mesh axis splits the plane.
    Returns (y2d, plane)."""
    batch, n_heads, sq, sk = mask_shape
    m, kdim = x2d.shape
    n = w2d.shape[1]
    if how == HOW_XLA:
        y = x2d @ w2d
        mask = dropout_rng.packed_mask(
            batch, n_heads, sq, sk, plan.cfg.p, plan.step_seed(step),
            plan.salt(layer_idx), plan.cfg.philox_rounds,
            plan.cfg.philox_bits, device=x2d.device)
        return y, mask
    if how not in (HOW_GEMM, HOW_STANDALONE):
        raise ValueError(f"no GEMM producer {how!r}")
    shard = shard_exec(policy, batch, n_heads)
    m_loc, n_loc, _ = (shard_host_gemm(m, n, kdim, shard.batch_shards,
                                       shard.head_shards)
                       if shard is not None else (m, n, kdim))
    blocks = pick_gemm_blocks(m_loc, n_loc, kdim)
    if blocks is None:
        raise ValueError(f"producer {how!r} planned for GEMM ({m_loc},"
                         f"{n_loc},{kdim}), which does not tile")
    seed, salt = plan.step_seed(step), plan.salt(layer_idx)

    def body(x_, w_):
        local_shape, hg, off = shard_mask_tile(shard, batch, n_heads, sq,
                                               sk)
        y, mask = _fused_gemm_call(x_, w_, plan, local_shape, seed, salt,
                                   blocks, plan.cfg.gemm_dtype,
                                   heads_global=hg, bh_offset=off)
        if (mask is None) != (how == HOW_STANDALONE):
            raise RuntimeError(
                f"producer {how!r} planned, but the GEMM+RNG kernel's "
                f"layout for GEMM ({x_.shape[0]},{w_.shape[1]},{kdim}) and "
                f"mask {local_shape} "
                f"{'is Region 3' if mask is None else 'emits the plane'}")
        if mask is None:
            # Region 3: the remainder runs in the standalone kernel
            mask = ops.dropout_mask(local_shape[0], local_shape[1], sq, sk,
                                    plan.cfg.p, seed, salt,
                                    plan.cfg.philox_rounds, heads_global=hg,
                                    bh_offset=off, device=x_.device)
        return y, mask

    if policy is None:
        return body(x2d, w2d)
    from repro_torch.compat import P, shard_map
    if shard is None:
        # no mesh axis splits the plane: the kernel runs on the replicated
        # tensors, as GSPMD replicates it
        return shard_map(body, mesh=policy.mesh,
                         in_specs=(P(None, None), P(None, None)),
                         out_specs=(P(None, None),
                                    P(None, None, None, None)))(x2d, w2d)
    return _gemm_with_mask_sharded(body, x2d, w2d, n_loc != n, shard)


def _gemm_with_mask_sharded(body, x2d, w2d, split_cols: bool,
                            shard: ShardExec):
    """Shard-local fused GEMM+RNG: each rank runs the kernel on its batch
    rows x head-axis columns of the GEMM and makes its (b_loc, h_loc) tile
    of the plane (global-position counters, bitwise slices). Rows follow
    the batch shards and -- when N divides -- columns follow the head
    shards, so a head-only mesh computes a distinct N-slice per rank; an
    indivisible N keeps replicated columns."""
    from repro_torch.compat import P, shard_map
    h = shard.h_spec if split_cols else None
    return shard_map(body, mesh=shard.mesh,
                     in_specs=(P(shard.b_spec, None), P(None, h)),
                     out_specs=(P(shard.b_spec, h), _plane_spec(shard)))(
        x2d, w2d)


# --------------------------------------------------------------------------
# grouped (MoE expert / RWKV channel-mix) hosting
# --------------------------------------------------------------------------

def grouped_layout_feasible(e: int, c: int, kdim: int, n: int, batch: int,
                            n_heads: int, sq: int, sk: int
                            ) -> Tuple[bool, Optional[Tuple[int, int, int]]]:
    """(feasible, blocks) of hosting a (batch, n_heads, sq, sk) mask under
    the combined grid of E (c, kdim) x (kdim, n) expert GEMMs: the exact
    predicate the grouped kernel applies."""
    blocks = pick_gemm_blocks(c, n, kdim)
    if blocks is None:
        return False, None
    bm, bn, _ = blocks
    n_steps = e * (c // bm) * (n // bn)
    return mask_layout_feasible(
        n_steps, batch, n_heads, sq, sk,
        mask_block_cols=mask_cols_cap(sq, sk)), blocks


def grouped_einsum(a3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """y[e] = a3[e] @ b3[e] as a tensor op (the non-hosted expert
    product)."""
    return torch.einsum("ecd,edf->ecf", a3, b3)


def grouped_gemm_seeded(a3: torch.Tensor, b3: torch.Tensor,
                        plan: DropoutPlan,
                        mask_shape: Tuple[int, int, int, int], seed, salt,
                        how: str, heads_global: int = 0, bh_offset=0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y[e] = a3[e] @ b3[e] with the packed plane for ``mask_shape`` = (B,
    H, SQ, SK) made by the schedule's planned producer ``how``:
    HOW_GEMM_GROUPED (the grouped GEMM+RNG kernel) or HOW_STANDALONE
    (Region 3: the same kernel with emission off -- for an fp8 plan the
    product unquantized, as JAX's is -- then the standalone Philox kernel).
    The host's dtype casts as JAX's (``_host_call``): "bf16" rounds both
    operands to bf16 and C back to ``a3``'s dtype, "f32" runs the kernel of
    the operands' own dtype. ``seed`` / ``salt`` are the folded step seed
    and layer salt (the MoE dispatch body's operands). Runs exactly that
    producer, and raises where the GEMM does not tile or the kernel's own
    layout check disagrees with the plan. Returns (y, plane)."""
    batch, n_heads, sq, sk = mask_shape
    e, c, kdim = a3.shape
    n = b3.shape[2]
    if how not in (HOW_GEMM_GROUPED, HOW_STANDALONE):
        raise ValueError(f"no grouped producer {how!r}")
    blocks = pick_gemm_blocks(c, n, kdim)
    if blocks is None:
        raise ValueError(f"producer {how!r} planned for grouped GEMM "
                         f"{e}x({c},{kdim})x({kdim},{n}), which does not "
                         f"tile")
    bm, bn, bk = blocks
    y, mask = _host_call(
        plan.cfg.gemm_dtype, ops.fused_gemm_rng_grouped,
        ops.fused_gemm_rng_grouped_fp8, a3, b3, mask_batch=batch,
        mask_heads=n_heads, mask_sq=sq, mask_sk=sk, p=plan.cfg.p, seed=seed,
        salt=salt, rounds=plan.cfg.philox_rounds, block_m=bm, block_n=bn,
        block_k=bk, mask_block_cols=mask_cols_cap(sq, sk),
        heads_global=heads_global, bh_offset=bh_offset)
    if (mask is None) != (how == HOW_STANDALONE):
        region = "is Region 3" if mask is None else "emits the plane"
        raise RuntimeError(
            f"producer {how!r} planned, but the grouped GEMM+RNG kernel's "
            f"layout for {e}x({c},{kdim})x({kdim},{n}) and mask "
            f"{mask_shape} {region}")
    if mask is None:
        mask = ops.dropout_mask(batch, n_heads, sq, sk, plan.cfg.p, seed,
                                salt, plan.cfg.philox_rounds,
                                heads_global=heads_global,
                                bh_offset=bh_offset, device=a3.device)
    return y, mask


def grouped_gemm_with_mask(a3: torch.Tensor, b3: torch.Tensor,
                           plan: DropoutPlan,
                           mask_shape: Tuple[int, int, int, int],
                           layer_idx, step, how: str, policy=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-plane grouped host: y[e] = a3[e] @ b3[e] plus the packed plane
    for ``mask_shape``, made by the schedule's planned producer ``how``:
    HOW_XLA (the tensor-op product and producer), or a grouped-kernel
    producer as in ``grouped_gemm_seeded``. The direct-call / RWKV
    channel-mix (E=1) entry point; the MoE dispatch calls
    ``grouped_gemm_seeded`` inside its own shard_map body. With a
    ``policy`` the kernel runs shard-local: the C rows follow the batch
    shards (token-ordered, E=1), the plane's tile the (batch, heads)
    shards. Returns (y, plane)."""
    batch, n_heads, sq, sk = mask_shape
    if how == HOW_XLA:
        mask = dropout_rng.packed_mask(
            batch, n_heads, sq, sk, plan.cfg.p, plan.step_seed(step),
            plan.salt(layer_idx), plan.cfg.philox_rounds,
            plan.cfg.philox_bits, device=a3.device)
        return grouped_einsum(a3, b3), mask
    seed, salt = plan.step_seed(step), plan.salt(layer_idx)
    if policy is None:
        return grouped_gemm_seeded(a3, b3, plan, mask_shape, seed, salt,
                                   how)
    from repro_torch.compat import P, shard_map
    shard = shard_exec(policy, batch, n_heads)

    def body(a_, b_):
        local_shape, hg, off = shard_mask_tile(shard, batch, n_heads, sq,
                                               sk)
        return grouped_gemm_seeded(a_, b_, plan, local_shape, seed, salt,
                                   how, heads_global=hg, bh_offset=off)

    rep3 = P(None, None, None)
    if shard is None:
        return shard_map(body, mesh=policy.mesh, in_specs=(rep3, rep3),
                         out_specs=(rep3, P(None, None, None, None)))(a3, b3)
    return _grouped_gemm_with_mask_sharded(body, a3, b3, shard)


def _grouped_gemm_with_mask_sharded(body, a3, b3, shard: ShardExec):
    """Shard-local grouped host (E=1 channel-mix): each rank runs the
    grouped kernel on its batch rows of the token-ordered C dim and emits
    its (b_loc, h_loc) tile of the plane."""
    from repro_torch.compat import P, shard_map
    xs = P(None, shard.b_spec, None)
    return shard_map(body, mesh=shard.mesh,
                     in_specs=(xs, P(None, None, None)),
                     out_specs=(xs, _plane_spec(shard)))(a3, b3)


@dataclasses.dataclass(frozen=True)
class FFNHost:
    """Instruction to a block's FFN half to host a mask producer under one
    of its GEMMs: models/layers.ffn_apply for dense FFNs (the dense fused
    kernel) and RWKV channel-mix (the grouped kernel, E=1),
    models/moe.moe_apply for MoE expert FFNs (the grouped kernel over the
    expert einsum). ``layer_idx`` is the CONSUMER layer (the next attention
    layer: the plane rides the carry there); ``how`` is the schedule's
    planned producer for the emission; ``policy`` runs it shard-local."""
    plan: DropoutPlan
    site: str                           # "ffn_up" | "ffn_down"
    mask_shape: Tuple[int, int, int, int]
    layer_idx: Any
    step: Any
    how: str = HOW_GEMM
    policy: Any = None


def block_gemm_shapes(cfg: ModelConfig, batch: int, seq: int,
                      dense_ffn: Optional[bool] = None
                      ) -> Dict[str, Tuple[int, int, int]]:
    """(m, n, k) of each candidate dense host GEMM in one transformer
    block; FFN sites only for blocks with a GEMM-shaped dense FFN."""
    d = cfg.d_model
    toks = batch * seq
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {
        "qkv": (toks, (nq + 2 * nkv) * hd, d),
        "prev_gemm": (toks, d, nq * hd),
    }
    if dense_ffn is None:
        dense_ffn = cfg.moe is None
    if dense_ffn and cfg.ffn in (FFNKind.SWIGLU, FFNKind.GEGLU,
                                 FFNKind.GELU):
        gated = cfg.ffn in (FFNKind.SWIGLU, FFNKind.GEGLU)
        shapes["ffn_up"] = (toks, (2 if gated else 1) * cfg.d_ff, d)
        shapes["ffn_down"] = (toks, d, cfg.d_ff)
    return shapes


def moe_expert_capacity(moe, tokens: int) -> int:
    """Per-source expert capacity C: the exact arithmetic of the dispatch
    in models/moe.py, shared so the schedule plans the grouped host on the
    (E, C) grid the dispatch walks."""
    return max(1, -(-tokens * moe.top_k
                    * int(round(moe.capacity_factor * 100))
                    // (100 * moe.n_experts)))


def grouped_host_shapes(cfg: ModelConfig, batch: int, seq: int,
                        batch_shards: int = 1, head_shards: int = 1,
                        seq_dispatch: bool = False,
                        moe_block: Optional[bool] = None
                        ) -> Dict[str, Tuple[int, int, int, int]]:
    """(E, C, k, n) of the grouped candidate host GEMMs of a block whose FFN
    has no dense 2D GEMM: the MoE expert einsum (E, C, D) x
    (E, D, F) -- "ffn_up" under the gate projection, "ffn_down" under the
    down projection -- and the RWKV channel-mix key / value GEMMs as E=1.
    ``moe_block`` is the per-layer block kind (a MoE stack's first-dense
    layers can carry an RWKV channel-mix FFN); None means cfg.moe is set.
    The shard arguments estimate a planned shard's local grid with JAX's
    arithmetic (tokens chunked over the batch shards, and over the head
    shards too under ``seq_dispatch``; experts split over the batch shards,
    an expert's width over the head shards): the counter layer proves the
    topology-2 cells on it, and a sharded run walks the same grid."""
    d = cfg.d_model
    tok_shards = max(1, batch_shards) * (max(1, head_shards)
                                         if seq_dispatch else 1)
    toks = (batch * seq) // tok_shards
    if moe_block is None:
        moe_block = cfg.moe is not None
    if moe_block:
        m = cfg.moe
        e, cap = m.n_experts, moe_expert_capacity(m, toks)
        if batch_shards > 1 and e % batch_shards == 0:
            e, cap = e // batch_shards, tok_shards * cap
        f = m.d_ff_expert
        if head_shards > 1 and f % head_shards == 0:
            f //= head_shards
        return {"ffn_up": (e, cap, d, f), "ffn_down": (e, cap, f, d)}
    if cfg.ffn == FFNKind.RWKV_CHANNEL:
        toks = (batch * seq) // max(1, batch_shards)
        return {"ffn_up": (1, toks, d, cfg.d_ff),
                "ffn_down": (1, toks, cfg.d_ff, d)}
    return {}


def rank_host_sites(cfg: ModelConfig, plan: DropoutPlan, batch: int,
                    seq: int, hw=None, batch_shards: int = 1,
                    head_shards: int = 1, seq_dispatch: bool = False
                    ) -> Tuple[Tuple[str, float], ...]:
    """Tileable candidate host GEMMs ranked best first by the perf model
    (``perfmodel.rank_host_gemms``): Region-1 headroom under closed-form
    hardware, negated net added cost under calibrated hardware. The JAX
    package's function, but the hardware when none is passed is the
    active tuned table's calibrated one, else ``GH100`` -- the card the
    port runs on (JAX falls back to ``TPU_V5E``) -- and a site whose GEMM
    the active column block puts in Region 3 is left out while another
    can host the plane (JAX ranks it as hosted). MoE expert and RWKV
    channel-mix blocks contribute their grouped FFN hosts, ranked on the
    grid the per-layer capability later judges."""
    from repro_torch.perfmodel.hardware import GH100
    from repro_torch.perfmodel.model import rank_host_gemms
    if hw is None:
        hw = _tuned_tables().active_hardware(plan.cfg.gemm_dtype)
    mask_elems = float(batch) * cfg.n_heads * seq * seq
    dtype_bytes = _DTYPE_BYTES.get(plan.cfg.gemm_dtype, 4)
    b_loc = batch // batch_shards if batch % batch_shards == 0 else batch
    h_loc = (cfg.n_heads // head_shards if cfg.n_heads % head_shards == 0
             else cfg.n_heads)
    shapes, hosts = {}, set()
    for site, (m, n, k) in block_gemm_shapes(cfg, batch, seq).items():
        m_loc = m // batch_shards
        if pick_gemm_blocks(m_loc, n, k) is not None:
            shapes[site] = (m_loc, n, k)
            mg, ng, _ = shard_host_gemm(m, n, k, batch_shards, head_shards)
            blocks = pick_gemm_blocks(mg, ng, k)
            if blocks is not None and mask_layout_feasible(
                    (mg // blocks[0]) * (ng // blocks[1]), b_loc, h_loc,
                    seq, seq, mask_block_cols=mask_cols_cap(seq, seq)):
                hosts.add(site)
    grouped = {}
    for site, (e, c, k, n) in grouped_host_shapes(
            cfg, batch, seq, batch_shards=batch_shards,
            head_shards=head_shards, seq_dispatch=seq_dispatch).items():
        if pick_gemm_blocks(c, n, k) is not None:
            grouped[site] = (e, c, n, k)
            if grouped_layout_feasible(e, c, k, n, b_loc, h_loc, seq,
                                       seq)[0]:
                hosts.add(site)
    if not shapes and not grouped:
        return ()
    if hosts and len(hosts) < len(shapes) + len(grouped):
        # a Region-3 GEMM cannot emit the plane: its producer runs
        # exposed whatever the model says of hosting there, and premask
        # and replay compute that GEMM in different kernels
        shapes = {s_: v for s_, v in shapes.items() if s_ in hosts}
        grouped = {s_: v for s_, v in grouped.items() if s_ in hosts}
    return rank_host_gemms(shapes, mask_elems, hw=hw or GH100,
                           rounds=plan.cfg.philox_rounds,
                           dtype_bytes=dtype_bytes, grouped=grouped)


def pick_host_site(cfg: ModelConfig, plan: DropoutPlan, batch: int,
                   seq: int, fuse_ok: bool = True, hw=None,
                   batch_shards: int = 1) -> str:
    """Resolve site="auto" to a concrete host: the best-ranked block GEMM
    that tiles for the fused kernel (``rank_host_sites``), or "xla" when
    the plan is not an overlap plan, the kernels cannot make its planes or
    nothing qualifies -- the JAX package's rule."""
    if not (plan.enabled and plan.overlapped):
        return "xla"
    if not fuse_ok or mask_kernel_unsupported_reason(
            plan, seq, seq) is not None:
        return "xla"
    ranked = rank_host_sites(cfg, plan, batch, seq, hw=hw,
                             batch_shards=batch_shards)
    return ranked[0][0] if ranked else "xla"
