"""Hardware limiter descriptions for the paper's performance model: the
JAX package's ``repro/perfmodel/hardware.py``, constant for constant. The
port's default target is ``GH100`` (the H100 the port runs on); ``TPU_V5E``
stays for parity with JAX's rankings.

The paper (Table 1) enumerates MMA math, L2 BW, HBM BW, RF BW, issue, ALU,
MUFU and FMA pipes, then observes that for LLM-block shapes the binding
limiters collapse to: GEMM -> MMA math; attention -> RF+issue; RNG ->
ALU+issue. We therefore model one aggregated *non-matmul throughput*
``nonmma_ops`` (effective elementwise ops/s through the issue/ALU/RF
bottleneck) alongside the matmul and memory roofs — the minimal model that
reproduces the paper's numbers (calibration in model.py; the fitted
per-element op counts are "effective ops" through that aggregate pipe).

GH100 constants are public-spec FP8 numbers; TPU_V5E uses the brief's
roofline constants (197 TFLOP/s bf16, 819 GB/s HBM) with the VPU as the
non-matmul pipe — the unit the fused gemm_rng kernel keeps busy while the
MXU runs the matmul.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    mma_flops: float          # matmul flops/s (dense)
    hbm_bw: float             # bytes/s
    nonmma_ops: float         # effective elementwise ops/s (issue/ALU/RF)
    # paper-measured interference factors (§3.1.1)
    rng_interference: float = 1.5    # RNG slowdown while GEMM runs
    gemm_interference: float = 1.04  # GEMM slowdown while RNG runs
    drop_overhead: float = 1.12      # attention x1.12 with dropping step
    rng_hidden_fused: float = 0.15   # 10-20% of RNG hidden when fused
    # measurement-calibrated extensions (repro_torch.tune.calibrate). A fixed
    # per-grid-step cost lets the tile-aware model see grid granularity;
    # the silicon constants above keep it at exactly 0 so every closed-form
    # number (headline_table and friends) is bit-for-bit unchanged.
    step_overhead: float = 0.0       # seconds per kernel grid step (fitted)
    calibrated_against: str = ""     # "" = closed-form spec constants

    @property
    def is_calibrated(self) -> bool:
        return bool(self.calibrated_against)

    def scaled(self, mma_mult: float) -> "Hardware":
        """Paper §5.3: hypothetical GPU with scaled MMA compute, non-Tensor
        limiters unchanged (memory assumed to keep pace)."""
        return dataclasses.replace(
            self, name=f"{self.name}-mma{mma_mult:g}x",
            mma_flops=self.mma_flops * mma_mult,
            hbm_bw=self.hbm_bw * mma_mult)

    @classmethod
    def calibrated(cls, base: "Hardware", *, mma_flops: float,
                   hbm_bw: float, nonmma_ops: float,
                   rng_interference: float, gemm_interference: float,
                   step_overhead: float, source: str) -> "Hardware":
        """A Hardware whose roofs and interference factors were FITTED to
        wall-time measurements (repro_torch.tune.calibrate) rather than taken
        from a spec sheet. ``source`` records what was measured (platform +
        cell count) and flips ``is_calibrated`` on, which switches the host
        ranking objective from raw Region-1 headroom to net added cost
        (model.rank_host_gemms): fitted interference makes over-hosting a
        measurable penalty, so the ranking stops assuming the biggest
        shadow is free."""
        if not source:
            raise ValueError("calibrated hardware needs a source tag")
        return dataclasses.replace(
            base, name=f"{base.name}-cal",
            mma_flops=float(mma_flops), hbm_bw=float(hbm_bw),
            nonmma_ops=float(nonmma_ops),
            rng_interference=float(rng_interference),
            gemm_interference=float(gemm_interference),
            step_overhead=float(step_overhead),
            calibrated_against=str(source))


# H100 SXM FP8 (the paper's platform): 1979 TFLOP/s dense FP8, HBM3
# 3.35 TB/s. nonmma_ops is the calibrated aggregate (see model.py).
GH100 = Hardware(
    name="GH100",
    mma_flops=1.979e15,
    hbm_bw=3.35e12,
    nonmma_ops=1.2e13,
)

# TPU v5e-class target (brief constants). VPU: 8x128 lanes x 4 ALUs at
# ~0.94 GHz ~= 3.9e12 elementwise ops/s. Interference on TPU is MXU/VPU
# co-issue inside one Mosaic kernel: the matmul pipeline claims some VPU
# slots for accumulation/copy traffic -> mild RNG slowdown, and the RNG
# VPU stream does not touch the MXU at all -> no GEMM slowdown.
TPU_V5E = Hardware(
    name="TPU-v5e",
    mma_flops=1.97e14,
    hbm_bw=8.19e11,
    nonmma_ops=3.9e12,
    rng_interference=1.25,
    gemm_interference=1.0,
    drop_overhead=1.12,
    rng_hidden_fused=0.15,
)
