"""Tuned tables: persistence and the process-wide hooks the planner reads.

A ``TunedTable`` is what the autotuner proves and the planner consumes:

  * ``calibrations`` -- per host dtype ("f32", "bf16"), the perf model's
    constants fitted to the card's measured times (throughputs,
    interference, per-step overhead) and the residuals that justify them.
    The model has one MMA rate a Hardware, and on the card an f32 host
    (six bf16 part products a product) runs about 6x slower than a bf16
    one, so each dtype gets its own fit (JAX's table holds one, for its
    one dtype). ``calibration=`` stands for every dtype.
  * ``gemm_blocks`` -- exact-shape ``(m, n, k) -> (bm, bn, bk)`` logical
    block overrides, each proven by the search's gates before it was
    recorded, keyed by the exact GEMM shape so a proof never applies
    beyond the operands it was made on.
  * ``mask_cols`` -- per ``(sq, sk)`` plane, the emission column block of
    the fused hosts.
  * ``cells`` -- per (config, shape bucket, dtype, topology): the tuned
    ``site="auto"`` resolution with its predicted and default costs and
    the proof record.
  * ``residuals`` -- the calibration's rows: per measured host cell, the
    closed-form and calibrated predictions beside the measured time.

The port's table has a schema of its own, ``tuned_torch/v1``, in
``TUNED_torch.json``: the JAX package's ``TUNED.json`` (``tuned/v1``) is
calibrated on CPU interpret-mode runs and its blocks are Pallas grids,
so it is refused. It has no flash blocks either: the flash kernels tile
64 x 64 whatever they are given (``tune/space.py``).

Consumption is through one module-global active table: ``install(table)``
(clears the schedule compile cache -- compiled plans embed block and site
choices), ``uninstall()`` and the ``overlay(table)`` context manager the
search judges a candidate under. The lookups (``active_blocks``,
``active_mask_cols``, ``active_hardware``) are what ``core/producer`` --
and through it the schedule compiler, the kernels' wrappers and
``analysis/counters`` -- consult, so the planned layout, the launched one
and the verified one cannot disagree. With no table installed every hook
returns its default: the shipped behaviour, bit for bit. Nothing loads a
table implicitly (``load_default`` is explicit).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

from repro_torch.perfmodel.hardware import GH100, Hardware

SCHEMA = "tuned_torch/v1"
# the JAX package's schema: its tables calibrate CPU interpret runs and
# carry Pallas grids
JAX_SCHEMA = "tuned/v1"
DEFAULT_PATH = "TUNED_torch.json"

# legality floor shared with core/producer: logical blocks are multiples
# of 8 dividing their dim; mask columns divide sk
_BLOCK_ALIGN = 8


@dataclasses.dataclass(frozen=True)
class Calibration:
    """The fitted constants and the evidence for them."""
    source: str                       # the card, its power limit, cells
    mma_flops: float
    hbm_bw: float
    nonmma_ops: float
    rng_interference: float
    gemm_interference: float
    step_overhead: float
    residual_closed_form: float       # mean relative error, GH100 constants
    residual_calibrated: float        # mean relative error, fitted
    n_cells: int

    def hardware(self, base: Hardware = GH100) -> Hardware:
        return Hardware.calibrated(
            base, mma_flops=self.mma_flops, hbm_bw=self.hbm_bw,
            nonmma_ops=self.nonmma_ops,
            rng_interference=self.rng_interference,
            gemm_interference=self.gemm_interference,
            step_overhead=self.step_overhead, source=self.source)

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, object]) -> "Calibration":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})


@dataclasses.dataclass(frozen=True)
class TunedCell:
    """One (config, shape bucket, dtype, topology) tuning result."""
    key: str                          # cell_key(...)
    site: str                         # tuned site="auto" resolution
    default_site: str                 # what the closed-form model picked
    predicted_s: float                # calibrated cost model, tuned choice
    default_s: float                  # calibrated cost model, default choice
    proof: Dict[str, bool]            # verify / mask_bits / gemm_bitwise /
                                      # forward_bitwise
    measured_on: str = ""             # the shapes the proofs ran on

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, object]) -> "TunedCell":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})


def cell_key(arch: str, batch: int, seq: int, dtype: str,
             mesh: str = "1x1") -> str:
    """Shape-bucketed cell key: batch and seq round up to a power of two
    so nearby shapes share one tuning decision."""
    def up2(v: int) -> int:
        p = 1
        while p < v:
            p *= 2
        return p
    return f"{arch}|b{up2(max(1, batch))}s{up2(max(1, seq))}|{dtype}|{mesh}"


def _shape_key(dims: Tuple[int, ...]) -> str:
    return "x".join(str(int(d)) for d in dims)


def _unkey(s: str) -> Tuple[int, ...]:
    return tuple(int(v) for v in s.split("x"))


# the key of a calibration that stands for every host dtype
ANY_DTYPE = "*"


class TunedTable:
    def __init__(self, calibration: Optional[Calibration] = None,
                 gemm_blocks: Optional[Dict[Tuple[int, int, int],
                                            Tuple[int, int, int]]] = None,
                 mask_cols: Optional[Dict[Tuple[int, int], int]] = None,
                 cells: Optional[Dict[str, TunedCell]] = None,
                 residuals: Optional[List[Dict[str, object]]] = None,
                 calibrations: Optional[Dict[str, Calibration]] = None):
        self.calibrations = dict(calibrations or {})
        if calibration is not None:
            self.calibrations[ANY_DTYPE] = calibration
        self.gemm_blocks = dict(gemm_blocks or {})
        self.mask_cols = dict(mask_cols or {})
        self.cells = dict(cells or {})
        self.residuals = list(residuals or [])

    # -- lookups (legality re-checked, so a hand-edited table can only
    #    fall back to the defaults, never hand a kernel an illegal grid) --

    def blocks_for(self, m: int, n: int, k: int
                   ) -> Optional[Tuple[int, int, int]]:
        b = self.gemm_blocks.get((m, n, k))
        if b is None:
            return None
        bm, bn, bk = b
        for dim, blk in ((m, bm), (n, bn), (k, bk)):
            if blk <= 0 or dim % blk or blk % _BLOCK_ALIGN:
                return None
        return (bm, bn, bk)

    def mask_cols_for(self, sq: int, sk: int) -> Optional[int]:
        c = self.mask_cols.get((sq, sk))
        if c is None or c <= 0 or sk % min(c, sk):
            return None
        return int(c)

    def calibration_for(self, dtype: Optional[str] = None
                        ) -> Optional[Calibration]:
        """The calibration of host dtype ``dtype``, else the one for every
        dtype, else None."""
        return self.calibrations.get(dtype) or \
            self.calibrations.get(ANY_DTYPE)

    @property
    def calibration(self) -> Optional[Calibration]:
        return self.calibrations.get(ANY_DTYPE)

    def hardware(self, dtype: Optional[str] = None) -> Optional[Hardware]:
        cal = self.calibration_for(dtype)
        return cal.hardware() if cal else None

    # -- persistence ----------------------------------------------------

    def to_json(self) -> Dict[str, object]:
        return {
            "schema": SCHEMA,
            "calibrations": {k: c.to_json()
                             for k, c in sorted(self.calibrations.items())},
            "gemm_blocks": {_shape_key(s): list(b)
                            for s, b in sorted(self.gemm_blocks.items())},
            "mask_cols": {_shape_key(s): c
                          for s, c in sorted(self.mask_cols.items())},
            "cells": {k: c.to_json()
                      for k, c in sorted(self.cells.items())},
            "residuals": self.residuals,
        }

    @classmethod
    def from_json(cls, d: Dict[str, object]) -> "TunedTable":
        schema = d.get("schema")
        if schema == JAX_SCHEMA:
            raise ValueError(
                f"schema {schema!r} is the JAX package's tuned table "
                "(calibrated on CPU interpret runs, Pallas grids); the "
                f"port reads {SCHEMA!r} ({DEFAULT_PATH})")
        if schema != SCHEMA:
            raise ValueError(f"unsupported tuned-table schema {schema!r} "
                             f"(want {SCHEMA!r})")
        return cls(
            calibrations={k: Calibration.from_json(c) for k, c
                          in (d.get("calibrations") or {}).items()},
            gemm_blocks={_unkey(s): tuple(b)
                         for s, b in (d.get("gemm_blocks") or {}).items()},
            mask_cols={_unkey(s): int(c)
                       for s, c in (d.get("mask_cols") or {}).items()},
            cells={k: TunedCell.from_json(c)
                   for k, c in (d.get("cells") or {}).items()},
            residuals=list(d.get("residuals") or []))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "TunedTable":
        with open(path) as f:
            return cls.from_json(json.load(f))


# --------------------------------------------------------------------------
# the process-wide active table
# --------------------------------------------------------------------------

_ACTIVE: Optional[TunedTable] = None


def install(table: Optional[TunedTable]) -> None:
    """Make ``table`` the process-wide tuned table (None uninstalls)."""
    global _ACTIVE
    _ACTIVE = table
    # compiled schedules embed block / site choices (imported here: the
    # schedule compiler's producer consults this module)
    from repro_torch.core import schedule
    schedule.clear_cache()


def uninstall() -> None:
    install(None)


def installed() -> Optional[TunedTable]:
    return _ACTIVE


@contextlib.contextmanager
def overlay(table: Optional[TunedTable]):
    """Temporarily install ``table`` (the search judges candidates under
    an overlay, so a rejected candidate never leaks into the defaults)."""
    prev = _ACTIVE
    install(table)
    try:
        yield table
    finally:
        install(prev)


def load_default(path: str = DEFAULT_PATH) -> Optional[TunedTable]:
    """Install the table at ``path`` if there is one; None otherwise."""
    if not os.path.exists(path):
        return None
    table = TunedTable.load(path)
    install(table)
    return table


# -- the hooks the planner, the kernels' wrappers and the verifier read ----

def active_blocks(m: int, n: int, k: int
                  ) -> Optional[Tuple[int, int, int]]:
    return _ACTIVE.blocks_for(m, n, k) if _ACTIVE is not None else None


def active_mask_cols(sq: int, sk: int, default: int = 2048) -> int:
    if _ACTIVE is not None:
        c = _ACTIVE.mask_cols_for(sq, sk)
        if c is not None:
            return c
    return default


def active_hardware(dtype: Optional[str] = None) -> Optional[Hardware]:
    """The active table's calibrated hardware for host dtype ``dtype``,
    or None."""
    return _ACTIVE.hardware(dtype) if _ACTIVE is not None else None
