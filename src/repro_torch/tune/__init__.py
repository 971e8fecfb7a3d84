"""repro_torch.tune -- the perf model calibrated on the card, and a
mask-safe autotuner for the fused hosts.

The measure -> calibrate -> search -> plan loop on top of the compiled
dropout schedule (the JAX package's ``repro/tune``):

  calibrate.py  times each host cell's (plain GEMM, standalone RNG, fused
                GEMM+RNG) triple on the card with CUDA events and fits the
                perfmodel's throughput / interference constants to them
                (``Hardware.calibrated``), with residuals against the
                closed-form GH100 model.
  space.py      the knobs the port's kernels take at run time: the
                logical GEMM blocks, the emission column block, the flash
                blocks (one value: the kernels tile 64 x 64) and
                philox_bits.
  search.py     coordinate descent over that space, every candidate gated
                by the mask bits, the kernel's own output bits and
                ``repro_torch.analysis.verify_schedule``: tuning never
                changes a mask bit or an output bit, and proves it per
                candidate.
  tables.py     tuned tables (``tuned_torch/v1``, ``TUNED_torch.json``)
                and the hooks ``pick_gemm_blocks`` / ``mask_cols_cap`` /
                ``rank_host_sites`` / ``compile_schedule(site="auto")``
                consult, with the shipped defaults when no table is
                installed. Nothing loads a table implicitly.

``python -m repro_torch.tune --smoke`` runs the loop on the CPU (the fit
arithmetic, plain versions); ``--device cuda`` measures and tunes on the
card and writes ``TUNED_torch.json``.
"""
from repro_torch.tune.tables import (  # noqa: F401
    Calibration,
    TunedCell,
    TunedTable,
    active_blocks,
    active_hardware,
    active_mask_cols,
    cell_key,
    install,
    installed,
    load_default,
    overlay,
    uninstall,
)
