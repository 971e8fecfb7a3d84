"""Coordinate-descent autotuner, every candidate gated by proof.

The objective is the calibrated cost model (``perfmodel.fused_host_time``
with the logical blocks' re-streaming traffic and the fitted per-step
overhead, plus the emission-burst term for the RNG grid) -- arithmetic,
so the search itself is fast; the JAX package's ``score``. What makes a
candidate admissible is never the score:

  gate 1 (mask bits)    the fused kernel at the candidate's blocks and
                        emission columns must make the untuned plan's
                        packed plane bit for bit (the standalone Philox
                        kernel's). ``philox_bits=8`` changes the bits
                        themselves and dies here.
  gate 2 (GEMM output)  the candidate's C must equal the same kernel's C
                        at the default point bitwise. JAX holds C to
                        ``x @ w``; the port's f32 and bf16 kernels tile
                        their products on their own (a fixed MMA tiling),
                        so their C is not bitwise ``torch.matmul``'s at
                        any point -- the yardstick is the kernel itself,
                        a deliberate divergence. At e4m3 a ``bk`` move
                        changes the scale tiles and dies here.
  gate 3 (flash output) the flash kernels tile 64 x 64 whatever they are
                        given: the one flash value passes trivially.
  gate 4 (verifier)     with the candidate overlaid as a tuned table,
                        ``compile_schedule`` + ``verify_schedule`` must
                        pass on the cell's configuration at the cell's
                        shape: the counter layer sees the grids the tuned
                        kernels would launch.

On the card the gates run the kernels; on the CPU their plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.perfmodel.hardware import Hardware
from repro_torch.perfmodel.model import fused_host_time, rng_ops_per_elem
from repro_torch.tune import space
from repro_torch.tune.space import Point
from repro_torch.tune.tables import TunedTable, overlay


@dataclasses.dataclass
class CellTuning:
    """One host GEMM's tuning outcome on one cell."""
    arch: str
    site: str
    gemm: Tuple[int, int, int]
    mask: Tuple[int, int, int, int]
    default: Point
    tuned: Point
    score_default: float
    score_tuned: float
    accepted: List[str]                   # moves taken
    admitted: List[str]                   # candidates past all four gates
    rejected: List[Tuple[str, str]]       # (candidate, which gate)
    proof: Dict[str, bool]


def _emission_layout(point: Point, m: int, n: int,
                     mask: Tuple[int, int, int, int]):
    from repro_torch.kernels.gemm_rng import mask_emission_layout
    bm, bn, _ = point.blocks
    if m % bm or n % bn:
        return None
    return mask_emission_layout((m // bm) * (n // bn), mask[0], mask[1],
                                mask[2], mask[3],
                                mask_block_cols=point.mask_cols)


def score(point: Point, m: int, n: int, k: int,
          mask: Tuple[int, int, int, int], hw: Hardware,
          rounds: int = 7, dtype_bytes: int = 4) -> float:
    """Calibrated predicted cost of running this host cell at ``point``,
    with the emission-burst term: RNG packed into fewer emission blocks
    than the GEMM has (i, j) shadow steps is exposed a step even when the
    whole-kernel Region-1 estimate hides it (the JAX package's)."""
    if any(d % b for d, b in zip((m, n, k), point.blocks)):
        return float("inf")
    layout = _emission_layout(point, m, n, mask)
    if layout is None:
        return float("inf")
    elems = float(mask[0]) * mask[1] * mask[2] * mask[3]
    base = fused_host_time(m, n, k, elems, hw, rounds=rounds,
                           dtype_bytes=dtype_bytes, blocks=point.blocks)
    bm, bn, _ = point.blocks
    n_ij = (m // bm) * (n // bn)
    n_emit = max(1, getattr(layout, "n_valid_blocks", n_ij))
    t_rng = (elems * rng_ops_per_elem(rounds) / hw.nonmma_ops) \
        * (point.philox_bits / 32.0)
    t_gemm = base - max(0.0, t_rng - base / hw.rng_interference)
    shadow_per_step = (t_gemm / hw.rng_interference) / max(n_ij, 1)
    burst = max(0.0, t_rng / n_emit - shadow_per_step) * n_emit
    bq, bkk = point.flash
    sq, sk = mask[2], mask[3]
    flash_steps = max(1, (sq // max(bq, 1)) * (sk // max(bkk, 1)))
    return base + burst + flash_steps * hw.step_overhead


def _desc(point: Point) -> str:
    return (f"bm{point.blocks[0]}.bn{point.blocks[1]}.bk{point.blocks[2]}"
            f".mc{point.mask_cols}.fa{point.flash[0]}x{point.flash[1]}"
            f".pb{point.philox_bits}")


def _candidate_table(gemm: Tuple[int, int, int], point: Point,
                    mask: Tuple[int, int, int, int]) -> TunedTable:
    return TunedTable(gemm_blocks={gemm: point.blocks},
                      mask_cols={(mask[2], mask[3]): point.mask_cols})


def _operands(m: int, n: int, k: int, dtype: str, device, seed: int = 29):
    import torch
    dt = {"f32": torch.float32, "bf16": torch.bfloat16,
          "fp8": torch.float32}[dtype]
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=device).to(dt)
    w = torch.randn((k, n), generator=gen, device=device).to(dt)
    return x, w


def _host(point: Point, x, w, mask, rounds: int, seed: int, salt: int,
          dtype: str):
    """C and the plane of the cell's host at ``point``."""
    from repro_torch.kernels import gemm_rng
    b, h, sq, sk = mask
    bm, bn, bk = point.blocks
    fn = gemm_rng.gemm_with_rng_fp8 if dtype == "fp8" \
        else gemm_rng.gemm_with_rng
    return fn(x, w, mask_batch=b, mask_heads=h, mask_sq=sq, mask_sk=sk,
              p=0.1, seed=seed, salt=salt, rounds=rounds, block_m=bm,
              block_n=bn, block_k=bk, mask_block_cols=point.mask_cols)


def prove_kernel_bits(point: Point, m: int, n: int, k: int,
                      mask: Tuple[int, int, int, int], rounds: int = 7,
                      seed: int = 11, salt: int = 5, dtype: str = "f32",
                      device=None) -> Tuple[Dict[str, bool], Optional[str]]:
    """Gates 1-3 on ``device`` (the kernels on the card, the plain versions
    on the CPU). Returns (proof flags, the failed gate or None)."""
    import torch

    from repro_torch.core import dropout_rng
    from repro_torch.kernels import ops
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    b, h, sq, sk = mask
    proof = {"mask_bits": False, "gemm_bitwise": False,
             "flash_bitwise": point.flash == space.FLASH_CHOICES[0]}
    ref_bits = ops.dropout_mask(b, h, sq, sk, 0.1, seed, salt, rounds,
                                device=dev)
    if point.philox_bits != 32:
        cand = dropout_rng.packed_mask(b, h, sq, sk, 0.1, seed, salt,
                                       rounds, point.philox_bits, device=dev)
        if not torch.equal(cand, ref_bits):
            return proof, "mask_bits"
    x, w = _operands(m, n, k, dtype, dev)
    with torch.no_grad():
        y, mk = _host(point, x, w, mask, rounds, seed, salt, dtype)
        if mk is None or not torch.equal(mk, ref_bits):
            return proof, "mask_bits"   # Region 3 at the point, or bits
        proof["mask_bits"] = True
        d = space.default_point(m, n, k, sq, sk)
        y_ref, _ = _host(d, x, w, mask, rounds, seed, salt, dtype)
    if not torch.equal(y, y_ref):
        return proof, "gemm_bitwise"
    proof["gemm_bitwise"] = True
    if not proof["flash_bitwise"]:
        return proof, "flash_bitwise"
    return proof, None


def prove_schedule(arch: str, site: str, gemm: Tuple[int, int, int],
                   point: Point, mask: Tuple[int, int, int, int],
                   dtype: str = "f32", reduced: bool = False) -> bool:
    """Gate 4: the counter layer under the candidate, on the cell's
    configuration (its reduced avatar with ``reduced``) at the cell's
    (batch, seq), at its site and at "auto"."""
    from repro_torch import analysis
    from repro_torch.config.base import DropoutPlanConfig
    from repro_torch.config.registry import get_arch
    from repro_torch.core.schedule import compile_schedule
    cfg = get_arch(arch, reduced=reduced)
    try:
        with overlay(_candidate_table(gemm, point, mask)):
            for s in (site, "auto"):
                plan = DropoutPlanConfig(mode="overlap", p=0.1, site=s,
                                         gemm_dtype=dtype)
                sched = compile_schedule(cfg, plan, mask[0], mask[2],
                                         attn_impl="pallas")
                analysis.verify_schedule(cfg, sched, cell=f"tune:{arch}")
    except Exception:
        return False
    return True


def tune_cell(arch: str, site: str, gemm: Tuple[int, int, int],
              mask: Tuple[int, int, int, int], hw: Hardware,
              rounds: int = 7, max_sweeps: int = 2, max_gate_runs: int = 12,
              dtype: str = "f32", device=None, reduced: bool = False
              ) -> CellTuning:
    """Coordinate descent from the shipped defaults. A move is taken only
    when it both improves the calibrated score and passes all four gates;
    gate-rejected candidates are recorded (the evidence the gates do
    work)."""
    m, n, k = gemm
    sq, sk = mask[2], mask[3]
    dbytes = {"f32": 4, "bf16": 2, "fp8": 1}[dtype]
    cur = space.default_point(m, n, k, sq, sk)
    cur_score = score(cur, m, n, k, mask, hw, rounds=rounds,
                      dtype_bytes=dbytes)
    default_point, default_score = cur, cur_score
    accepted: List[str] = []
    rejected: List[Tuple[str, str]] = []
    proof: Dict[str, bool] = {"mask_bits": True, "gemm_bitwise": True,
                              "flash_bitwise": True, "verify": True}
    gate_runs = 0
    seen_bad = set()

    admitted: List[str] = []

    def gates(cand: Point) -> Optional[str]:
        flags, failed = prove_kernel_bits(cand, m, n, k, mask, rounds=rounds,
                                          dtype=dtype, device=device)
        if failed is None and not prove_schedule(arch, site, gemm, cand,
                                                 mask, dtype, reduced):
            failed = "verify"
        if failed is None:
            proof.update(flags)
            admitted.append(_desc(cand))
        else:
            rejected.append((_desc(cand), failed))
            seen_bad.add(cand)
        return failed

    for _ in range(max_sweeps):
        improved = False
        for coord in space.COORDS:
            ranked = sorted(
                ((score(p, m, n, k, mask, hw, rounds=rounds,
                        dtype_bytes=dbytes), p)
                 for p in space.neighbors(cur, coord, m, n, k, sq, sk)),
                key=lambda sp: sp[0])
            for cand_score, cand in ranked:
                if cand_score >= cur_score or not np.isfinite(cand_score):
                    break                  # ranked: the rest are no better
                if cand in seen_bad:
                    continue
                if gate_runs >= max_gate_runs:
                    break
                gate_runs += 1
                if gates(cand) is not None:
                    continue
                cur, cur_score = cand, cand_score
                accepted.append(_desc(cand))
                improved = True
                break
        if not improved:
            break
    # the gates must be shown at work: philox_bits=8 changes the bits and
    # must die at gate 1, and a legal block move must pass all four even
    # where no move improves the score (it is then admitted, not taken)
    if not any(g in ("mask_bits", "gemm_bitwise") for _, g in rejected):
        gates(space.with_coord(cur, "philox_bits", 8))
    if not admitted:
        moves = [(score(p, m, n, k, mask, hw, rounds=rounds,
                        dtype_bytes=dbytes), p)
                 for coord in ("bm", "bn", "mask_cols")
                 for p in space.neighbors(cur, coord, m, n, k, sq, sk)]
        finite = sorted((sp for sp in moves if np.isfinite(sp[0])),
                        key=lambda sp: sp[0])
        if finite:
            gates(finite[0][1])
    return CellTuning(arch=arch, site=site, gemm=gemm, mask=mask,
                      default=default_point, tuned=cur,
                      score_default=default_score, score_tuned=cur_score,
                      accepted=accepted, admitted=admitted,
                      rejected=rejected, proof=proof)


def gemm_cells_for_arch(arch: str, batch: int, seq: int,
                        reduced: bool = True
                        ) -> List[Tuple[str, Tuple[int, int, int]]]:
    """The tileable dense host GEMMs of the arch (its reduced avatar by
    default)."""
    from repro_torch.config.registry import get_arch
    from repro_torch.core.producer import block_gemm_shapes, pick_gemm_blocks
    cfg = get_arch(arch, reduced=reduced)
    return [(site, (m, n, k)) for site, (m, n, k)
            in block_gemm_shapes(cfg, batch, seq).items()
            if pick_gemm_blocks(m, n, k) is not None]
