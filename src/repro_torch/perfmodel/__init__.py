"""repro_torch.perfmodel -- the paper's analytic performance model
(``model.py``) and the hardware it is evaluated on (``hardware.py``).
"""
from repro_torch.perfmodel.hardware import GH100, TPU_V5E, Hardware
from repro_torch.perfmodel.model import (
    BlockShape,
    block_speedup,
    fused_host_time,
    gemm_grid_steps,
    gemm_host_cost,
    gemm_tile_time,
    gemm_tile_traffic_bytes,
    kernel_times,
    overlap_block_time,
    baseline_block_time,
    rank_host_gemms,
    sweep_speedup,
)

__all__ = [
    "GH100",
    "TPU_V5E",
    "Hardware",
    "BlockShape",
    "block_speedup",
    "fused_host_time",
    "gemm_grid_steps",
    "gemm_host_cost",
    "gemm_tile_time",
    "gemm_tile_traffic_bytes",
    "kernel_times",
    "overlap_block_time",
    "baseline_block_time",
    "rank_host_gemms",
    "sweep_speedup",
]
