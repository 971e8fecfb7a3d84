"""Calibration of the perf model against the card.

On the card (``measure_cells``) each candidate host cell is timed as a
triple, with CUDA events, in turns, after a warm-up: the host's kernel
with the emission off (the plain GEMM), ``philox_mask.cu`` alone (the
standalone RNG) and the fused GEMM+RNG launch. The cells are the smoke's
training shapes: llama2-7b's QKV, out-projection, gate+up and down GEMMs
and moonshot-v1-16b-a3b's grouped gate (64 experts, capacity 480), at B
= 2, S = 2048, each at f32 and bf16. ``fit`` then fits the perfmodel's
constants to the measured times of one host dtype (``fit_by_dtype``:
one fit a dtype, since the model has one MMA rate and an f32 host runs
about 6x slower than a bf16 one),

  t  ~=  th_mma * flops + th_hbm * bytes + th_rng * rng_ops
         + th_step * grid_steps,

by non-negative least squares, turns the sensitivities into throughputs
(``Hardware.calibrated``), takes the interference factors from the
triples by the paper's Fig. 5f composition and reports residuals against
the closed-form ``GH100``: the JAX package's ``repro/tune/calibrate.py``
arithmetic, its ``_nnls`` copied. Flops come from
``roofline/counts.feature_vector`` (the FLOP counter, with a formula for
each kernel operator), bytes and RNG operations from the analytic counts.
A grouped cell (E experts) is predicted with the grouped operand
arithmetic (each expert streams its own weight) in the same composition.

On the CPU only the fit arithmetic runs (``fit`` on recorded
measurements): CPU times say nothing about Hopper.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.perfmodel.hardware import GH100, Hardware
from repro_torch.perfmodel.model import fused_host_time, rng_ops_per_elem
from repro_torch.tune.tables import Calibration

# interference-fit clamps (the JAX package's): the model only needs sane
# positives
_GIF_RANGE = (1.01, 8.0)
_RIF_RANGE = (1.05, 8.0)

# the smoke's training shapes: (arch, site, grouped) at B x S
CELL_ARCHS = (("llama2-7b", ("qkv", "prev_gemm", "ffn_up", "ffn_down")),
              ("moonshot-v1-16b-a3b", ("ffn_up",)))
CELL_BATCH = 2
CELL_SEQ = 2048
CELL_DTYPES = ("f32", "bf16")
# the standalone TPU kernel's logical grid (philox.py's DEFAULT_ROWS32_BLK,
# DEFAULT_BK): the unit its steps are counted in, as JAX's fit counts them
_RNG_ROWS32_BLK = 8
_RNG_COLS_BLK = 512


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One measured host cell: the (plain GEMM, standalone RNG, fused
    GEMM+RNG) time triple in seconds, and its cost features."""
    arch: str
    site: str
    m: int
    n: int
    k: int
    mask: Tuple[int, int, int, int]       # (b, h, sq, sk)
    rounds: int
    dtype_bytes: int
    n_steps: int                          # fused host's logical grid steps
    rng_steps: int                        # standalone RNG's logical steps
    t_dot: float
    t_rng: float
    t_fused: float
    features: Dict[str, float]            # roofline/counts.feature_vector
    e: int = 1                            # experts (a grouped host)
    dtype: str = "f32"

    @property
    def mask_elems(self) -> float:
        b, h, sq, sk = self.mask
        return float(b) * h * sq * sk

    @property
    def rng_ops(self) -> float:
        return self.mask_elems * rng_ops_per_elem(self.rounds)

    @property
    def flops(self) -> float:
        return 2.0 * self.e * self.m * self.n * self.k

    @property
    def gemm_bytes(self) -> float:
        return self.e * ((self.m * self.k + self.k * self.n)
                         * self.dtype_bytes + self.m * self.n * 4.0)

    def to_json(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["mask"] = list(self.mask)
        return d

    @classmethod
    def from_json(cls, d: Dict[str, object]) -> "Measurement":
        kw = {f.name: d[f.name] for f in dataclasses.fields(cls)
              if f.name in d}
        kw["mask"] = tuple(kw["mask"])
        return cls(**kw)


def predict(ms: Measurement, hw: Hardware) -> float:
    """The model's time of the cell's fused launch: ``fused_host_time``
    for a dense host; for a grouped one the same Fig. 5f composition on
    the grouped operand arithmetic."""
    if ms.e == 1:
        return fused_host_time(ms.m, ms.n, ms.k, ms.mask_elems, hw,
                               rounds=ms.rounds, dtype_bytes=ms.dtype_bytes)
    t_gemm = max(ms.flops / hw.mma_flops, ms.gemm_bytes / hw.hbm_bw)
    t_rng = max(ms.rng_ops / hw.nonmma_ops, ms.mask_elems / 8.0 / hw.hbm_bw)
    stretched = t_gemm * hw.gemm_interference
    return stretched + max(0.0, t_rng - stretched / hw.rng_interference)


def _nnls(A: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Tiny non-negative least squares: solve, clamp negative coords to
    zero, re-solve on the surviving columns until stable."""
    active = list(range(A.shape[1]))
    theta = np.zeros(A.shape[1])
    for _ in range(A.shape[1] + 1):
        if not active:
            break
        sol, *_ = np.linalg.lstsq(A[:, active], y, rcond=None)
        if (sol >= 0).all():
            for i, c in enumerate(active):
                theta[c] = sol[i]
            return theta
        active = [c for c, v in zip(active, sol) if v > 0]
    for i, c in enumerate(active):
        theta[c] = max(0.0, float(sol[i]))
    return theta


def fit(measurements: Sequence[Measurement], source: str,
        base: Hardware = GH100) -> Calibration:
    """Fit Hardware constants and interference factors to the measured
    triples, then report residuals against ``base``'s closed form."""
    if not measurements:
        raise ValueError("no measurements to calibrate from")
    rows, y = [], []
    for ms in measurements:
        mask_bytes = ms.mask_elems / 8.0
        # one row per member of the triple: shared terms, different mixes
        rows.append([ms.flops, ms.gemm_bytes, 0.0, 0.0])
        y.append(ms.t_dot)
        rows.append([0.0, mask_bytes, ms.rng_ops, ms.rng_steps])
        y.append(ms.t_rng)
        feats = ms.features
        rows.append([feats.get("flops") or ms.flops,
                     feats.get("bytes") or ms.gemm_bytes + mask_bytes,
                     ms.rng_ops, ms.n_steps])
        y.append(ms.t_fused)
    theta = _nnls(np.asarray(rows), np.asarray(y))
    eps = 1e-18
    mma = 1.0 / max(theta[0], eps) if theta[0] > 0 else base.mma_flops
    hbm = 1.0 / max(theta[1], eps) if theta[1] > 0 else base.hbm_bw
    nonmma = 1.0 / max(theta[2], eps) if theta[2] > 0 \
        else base.nonmma_ops
    step = float(theta[3])

    # interference from the triples (Fig. 5f composition, measured)
    gifs, rifs = [], []
    for ms in measurements:
        if ms.t_dot <= 0 or ms.t_rng <= 0:
            continue
        gif = max(ms.t_fused - ms.t_rng, 0.0) / ms.t_dot
        gifs.append(min(max(gif, _GIF_RANGE[0]), _GIF_RANGE[1]))
        exposed = max(0.0, ms.t_fused - gif * ms.t_dot)
        hidden = ms.t_rng - exposed
        rif = (gif * ms.t_dot / hidden) if hidden > 0 else _RIF_RANGE[1]
        rifs.append(min(max(rif, _RIF_RANGE[0]), _RIF_RANGE[1]))
    gif = float(np.median(gifs)) if gifs else base.gemm_interference
    rif = float(np.median(rifs)) if rifs else base.rng_interference

    def residual(hw: Hardware) -> float:
        return float(np.mean([abs(predict(ms, hw) - ms.t_fused) / ms.t_fused
                              for ms in measurements]))

    def make(scale: float) -> Hardware:
        return Hardware.calibrated(
            base, mma_flops=mma / scale, hbm_bw=hbm / scale,
            nonmma_ops=nonmma / scale, rng_interference=rif,
            gemm_interference=gif, step_overhead=step * scale,
            source=source)

    # one global rescale centres the composed prediction on the measured
    # times (the sum-form fit against the max-form model leaves a bounded
    # systematic factor; the median ratio removes it)
    hw1 = make(1.0)
    ratios = [ms.t_fused / max(predict(ms, hw1), 1e-15)
              for ms in measurements]
    scale = float(np.median(ratios)) or 1.0
    hw = make(scale)
    return Calibration(
        source=source,
        mma_flops=hw.mma_flops, hbm_bw=hw.hbm_bw,
        nonmma_ops=hw.nonmma_ops, rng_interference=rif,
        gemm_interference=gif, step_overhead=hw.step_overhead,
        residual_closed_form=residual(base),
        residual_calibrated=residual(hw),
        n_cells=len(measurements))


def fit_by_dtype(measurements: Sequence[Measurement], source: str,
                 base: Hardware = GH100) -> Dict[str, Calibration]:
    """One ``fit`` a host dtype: the model has one MMA rate a Hardware,
    and on the card an f32 host (six bf16 part products a product) runs
    about 6x slower than a bf16 one, so one fit of both would sit between
    them."""
    out = {}
    for dtype in sorted({ms.dtype for ms in measurements}):
        cells = [ms for ms in measurements if ms.dtype == dtype]
        out[dtype] = fit(cells, f"{source} | {dtype}", base)
    return out


def residual_rows(measurements: Sequence[Measurement], cal: Calibration,
                  base: Hardware = GH100) -> List[Dict[str, object]]:
    """Per-cell closed-form against calibrated prediction rows, each with
    its measured triple (what the tuned table records)."""
    hw = cal.hardware(base)
    out = []
    for ms in measurements:
        closed, fitted = predict(ms, base), predict(ms, hw)
        out.append({
            "arch": ms.arch, "site": ms.site, "dtype": ms.dtype,
            "measurement": ms.to_json(),
            "measured_s": ms.t_fused,
            "pred_closed_form_s": closed,
            "pred_calibrated_s": fitted,
            "rel_err_closed_form": abs(closed - ms.t_fused) / ms.t_fused,
            "rel_err_calibrated": abs(fitted - ms.t_fused) / ms.t_fused,
        })
    return out


def residual_rows_by_dtype(measurements: Sequence[Measurement],
                           cals: Dict[str, Calibration],
                           base: Hardware = GH100
                           ) -> List[Dict[str, object]]:
    """``residual_rows`` of each dtype's cells against its calibration."""
    return [row for dtype, cal in sorted(cals.items())
            for row in residual_rows([ms for ms in measurements
                                      if ms.dtype == dtype], cal, base)]


# --------------------------------------------------------------------------
# measurement on the card
# --------------------------------------------------------------------------

def cell_shapes(batch: int = CELL_BATCH, seq: int = CELL_SEQ
                ) -> List[Tuple[str, str, Tuple[int, int, int, int],
                                Tuple[int, int, int, int]]]:
    """(arch, site, (E, M, N, K), plane (B, H, SQ, SK)) of every measured
    cell: the dense host GEMMs of llama2-7b and the grouped gate of
    moonshot-v1-16b-a3b, at full width."""
    from repro_torch.config.registry import get_arch
    from repro_torch.core import producer
    out = []
    for arch, sites in CELL_ARCHS:
        cfg = get_arch(arch)
        mask = (batch, cfg.n_heads, seq, seq)
        dense = producer.block_gemm_shapes(cfg, batch, seq)
        grouped = producer.grouped_host_shapes(cfg, batch, seq)
        for site in sites:
            if site in dense:
                m, n, k = dense[site]
                out.append((arch, site, (1, m, n, k), mask))
            else:
                e, c, k, n = grouped[site]
                out.append((arch, site, (e, c, n, k), mask))
    return out


def _timed(fn, start, end) -> float:
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def measure_cells(dtypes: Sequence[str] = CELL_DTYPES, repeats: int = 7,
                  warmup: int = 2, rounds: int = 7, seed: int = 7,
                  cells=None, device: str = "cuda"
                  ) -> List[Measurement]:
    """Time every cell's triple on the card: CUDA events, ``repeats``
    rounds after ``warmup``, the three launches of a cell in turns; each
    member's median. Returns one Measurement per (cell, dtype)."""
    import torch

    from repro_torch.core import producer
    from repro_torch.kernels import gemm_rng, philox
    from repro_torch.roofline import counts
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    gen = torch.Generator(device=device).manual_seed(seed)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    for arch, site, (e, m, n, k), mask in (cells or cell_shapes()):
        b, h, sq, sk = mask
        blocks = producer.pick_gemm_blocks(m, n, k)
        bm, bn, bk = blocks
        lead = (e,) if e > 1 else ()
        grouped = e > 1
        words = philox._key_args(0.1, seed, 3, 0)
        plane = torch.empty((b, h, sq // 32, sk), dtype=torch.int32,
                            device=device)
        em = gemm_rng._layout_emission(
            e * (m // bm) * (n // bn), b, h, sq, sk, 0.1, seed, 3, rounds,
            producer.mask_cols_cap(sq, sk), 256, 0, 0)
        if em is None:
            continue                     # Region 3: no fused triple
        for name in dtypes:
            a = torch.randn((*lead, m, k), generator=gen, device=device,
                            dtype=torch.float32).to(dt[name])
            w = torch.randn((*lead, k, n), generator=gen, device=device,
                            dtype=torch.float32).to(dt[name])
            fwd = gemm_rng._forward
            triple = {
                "dot": lambda: fwd(a, w, None),
                "rng": lambda: philox.philox_mask_into(
                    plane, rounds=rounds, **words),
                "fused": lambda: fwd(a, w, em)}
            times = {key: [] for key in triple}
            for r in range(warmup + repeats):
                for key, fn in triple.items():
                    t = _timed(fn, start, end)
                    if r >= warmup:
                        times[key].append(t)
            feats = counts.feature_vector(
                lambda x, y: fwd(x, y, em), a, w, plane=mask, rounds=rounds)
            rows32 = b * h * (sq // 32)
            out.append(Measurement(
                arch=arch, site=site, m=m, n=n, k=k, mask=mask,
                rounds=rounds, dtype_bytes=a.element_size(),
                n_steps=e * (m // bm) * (n // bn) * (k // bk),
                rng_steps=(-(-rows32 // _RNG_ROWS32_BLK))
                * (-(-sk // min(_RNG_COLS_BLK, sk))),
                t_dot=float(np.median(times["dot"])),
                t_rng=float(np.median(times["rng"])),
                t_fused=float(np.median(times["fused"])),
                features=feats, e=e, dtype=name))
            del a, w
    return out


def card_source(n_cells: int) -> str:
    """The calibration's source tag: the card's name and power limit as
    ``nvidia-smi`` gives them, and the cell count."""
    import subprocess
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = "nvidia-smi unavailable"
    return f"{smi} | CUDA events, B={CELL_BATCH} S={CELL_SEQ} x{n_cells}cells"


def calibrate(dtypes: Sequence[str] = CELL_DTYPES, repeats: int = 7
              ) -> Tuple[Dict[str, Calibration], List[Measurement]]:
    """Measure on the card and fit each dtype."""
    measurements = measure_cells(dtypes, repeats=repeats)
    return (fit_by_dtype(measurements, card_source(len(measurements))),
            measurements)


def recorded_measurements(rows: Sequence[Dict[str, object]]
                          ) -> List[Measurement]:
    """The measurements a tuned table's residual rows recorded (to refit
    them on the CPU)."""
    return [Measurement.from_json(r["measurement"]) for r in rows
            if "measurement" in r]


def measured_site_costs(measurements: Sequence[Measurement],
                        dtype: Optional[str] = None
                        ) -> Dict[Tuple[str, str], float]:
    """(arch, site) -> the measured added cost of hosting the plane there:
    t_fused - t_dot, the quantity the calibrated ranking predicts."""
    return {(ms.arch, ms.site): ms.t_fused - ms.t_dot for ms in measurements
            if dtype is None or ms.dtype == dtype}
