"""``python -m repro_torch.tune [--smoke] [--device cuda]``: calibrate the
perf model and autotune the fused hosts.

  1. CALIBRATE  on the card (``--device cuda``): time every host cell's
                (plain GEMM, standalone RNG, fused GEMM+RNG) triple and
                fit the model's constants, one fit a host dtype
                (``tune/calibrate.py``); each fitted model must predict
                its measured times better than the closed-form GH100
                constants (strictly smaller mean relative error), or
                nothing is written. On the CPU
                (``--smoke``) only the fit arithmetic runs: on the
                measurements an existing table recorded, if there is one.
  2. SEARCH     gated coordinate descent per host cell (``tune/search.py``):
                a candidate must win on the calibrated score and pass the
                mask-bit, GEMM-bit, flash and verifier gates. On the card
                the cells are llama2-7b's host GEMMs at B = 2, S = 2048;
                on the CPU the reduced avatars', with the plain versions.
  3. RESOLVE    rank ``site="auto"`` for every shipped config at B x S
                under the closed-form GH100 and under the calibrated
                hardware, and record each cell (the two picks may agree:
                a flip is reported, not required).
  4. PROVE      under the assembled table: the counter layer over every
                config's ``site="auto"`` schedule, and each tuned arch's
                reduced ``site="auto"`` forward bitwise the forward at the
                site it resolves to, fixed, with no table.
  5. PERSIST    write the table (``tuned_torch/v1``).

Exit codes: 0 written; 2 the calibration does not beat the closed form;
3 a schedule fails the verifier under the table; 4 a forward is not
bitwise the untuned one.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional

SMOKE_ARCHS = ("llama2-7b", "yi-6b")


def _log(msg: str) -> None:
    print(f"[tune] {msg}", flush=True)


def site_picks(arch: str, batch: int, seq: int, dtype: str, hw_closed,
               hw_cal):
    """(closed-form site, calibrated site, the calibrated model's cost of
    each) for the full-size ``arch`` at (batch, seq); None when no host
    ranks. Under calibrated hardware the ranking's scores are negated net
    host costs."""
    from repro_torch.config.base import DropoutPlanConfig
    from repro_torch.config.registry import get_arch
    from repro_torch.core.overlap import DropoutPlan
    from repro_torch.core.producer import rank_host_sites
    cfg = get_arch(arch)
    plan = DropoutPlan(DropoutPlanConfig(mode="overlap", p=0.1, site="auto",
                                         gemm_dtype=dtype))
    base = rank_host_sites(cfg, plan, batch, seq, hw=hw_closed)
    cal = rank_host_sites(cfg, plan, batch, seq, hw=hw_cal)
    if not base or not cal:
        return None
    costs = {site: -score for site, score in cal}
    return (base[0][0], cal[0][0],
            costs.get(base[0][0], float("nan")), costs[cal[0][0]])


def forward_bitwise(arch: str, batch: int, seq: int, table,
                    device: str):
    """The reduced avatar's ``site="auto"`` forward under ``table`` against
    the forward at the site it resolves to, fixed, with no table: bitwise
    equal logits (the table may move the blocks and pick the site; at one
    site the bits and the arithmetic may not move -- across sites they
    do, since the port's fused hosts are not bitwise ``torch.matmul``).
    Returns (equal, the resolved site)."""
    import torch

    from repro_torch.config.base import DropoutPlanConfig
    from repro_torch.config.registry import get_arch
    from repro_torch.core.overlap import DropoutPlan
    from repro_torch.core.schedule import compile_schedule
    from repro_torch.models import Runtime, forward, model_init
    from repro_torch.tune.tables import overlay
    cfg = get_arch(arch, reduced=True)
    params = model_init(cfg, seed=17, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    if cfg.frontend == "token":
        inputs = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=gen, device=device,
                               dtype=torch.int32)
    else:
        inputs = torch.randn((batch, seq, cfg.d_model), generator=gen,
                             device=device)

    def run(site):
        plan = DropoutPlanConfig(mode="overlap", p=0.1, seed=5, site=site)
        rt = Runtime(plan=DropoutPlan(plan), step=0, attn_impl="pallas")
        with torch.no_grad():
            return forward(params, cfg, rt, inputs)[0]

    with overlay(table):
        site = compile_schedule(cfg, DropoutPlanConfig(
            mode="overlap", p=0.1, site="auto"), batch, seq,
            attn_impl="pallas").resolved_site
        got = run("auto")
    with overlay(None):
        ref = run(site)
    return bool(torch.equal(ref, got)), site


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="calibrate the perf model on the card and autotune "
                    "the fused hosts")
    ap.add_argument("--smoke", action="store_true",
                    help="the CPU lane: the fit arithmetic, the reduced "
                         "avatars' first host cell, plain versions")
    ap.add_argument("--device", default=None,
                    help="cuda (the card: measure and tune) or cpu; "
                         "default cuda, or cpu with --smoke")
    ap.add_argument("--batch", type=int, default=2,
                    help="batch of the site cells (full-size configs)")
    ap.add_argument("--seq", type=int, default=2048,
                    help="sequence of the site cells (full-size configs)")
    ap.add_argument("--repeats", type=int, default=7,
                    help="timed rounds a measured cell, after warm-up")
    ap.add_argument("--dtypes", default="f32,bf16",
                    help="host dtypes to measure and tune")
    ap.add_argument("--out", default=None,
                    help="the table to write (default TUNED_torch.json on "
                         "the card, build/tune_smoke/TUNED_torch.json with "
                         "--smoke)")
    args = ap.parse_args(argv)
    device = args.device or ("cpu" if args.smoke else "cuda")
    out = args.out or ("build/tune_smoke/TUNED_torch.json" if args.smoke
                       else "TUNED_torch.json")
    dtypes = [d for d in args.dtypes.split(",") if d]

    from repro_torch import analysis
    from repro_torch.config.base import DropoutPlanConfig
    from repro_torch.config.registry import get_arch, list_archs
    from repro_torch.core.schedule import compile_schedule
    from repro_torch.perfmodel.hardware import GH100
    from repro_torch.tune import calibrate as cal_mod
    from repro_torch.tune import search
    from repro_torch.tune.tables import (
        DEFAULT_PATH,
        TunedCell,
        TunedTable,
        cell_key,
        overlay,
    )

    # -- 1. calibrate ------------------------------------------------------
    cals, residuals = {}, []
    if device == "cuda":
        _log(f"measuring {len(cal_mod.cell_shapes())} host cells x "
             f"{dtypes} on the card ({args.repeats} rounds in turns)")
        measurements = cal_mod.measure_cells(dtypes, repeats=args.repeats)
        cals = cal_mod.fit_by_dtype(measurements,
                                    cal_mod.card_source(len(measurements)))
    else:
        shipped = (TunedTable.load(DEFAULT_PATH)
                   if os.path.exists(DEFAULT_PATH) else TunedTable())
        measurements = [ms for ms in cal_mod.recorded_measurements(
            shipped.residuals) if ms.dtype in dtypes]
        if measurements:
            _log(f"refitting the {len(measurements)} measurements "
                 f"{DEFAULT_PATH} recorded (fit arithmetic only)")
            cals = {d: cal_mod.fit([ms for ms in measurements
                                    if ms.dtype == d],
                                   shipped.calibrations[d].source)
                    for d in sorted({ms.dtype for ms in measurements})}
    for dtype, cal in sorted(cals.items()):
        _log(f"{dtype} residuals: closed-form GH100 "
             f"{cal.residual_closed_form:.4f} -> calibrated "
             f"{cal.residual_calibrated:.4f} ({cal.n_cells} cells)")
        if not cal.residual_calibrated < cal.residual_closed_form:
            _log(f"FAIL: the {dtype} calibration does not beat the closed "
                 "form")
            return 2
    residuals = cal_mod.residual_rows_by_dtype(measurements, cals)
    for r in residuals:
        _log(f"  {r['arch']}/{r['site']}/{r['dtype']}: measured "
             f"{r['measured_s'] * 1e3:.4f} ms, GH100 "
             f"{r['pred_closed_form_s'] * 1e3:.4f} ms, calibrated "
             f"{r['pred_calibrated_s'] * 1e3:.4f} ms")
    if not cals:
        _log("no measurements here: the closed-form GH100 model ranks")

    def hw_for(dtype):
        return cals[dtype].hardware() if dtype in cals else GH100

    # -- 2. search ---------------------------------------------------------
    gemm_blocks: Dict = {}
    mask_cols: Dict = {}
    tunings = []
    if args.smoke:
        cells = [(arch, dtypes[0], True, (2, get_arch(arch, True).n_heads,
                                          128, 128), c)
                 for arch in SMOKE_ARCHS
                 for c in search.gemm_cells_for_arch(arch, 2, 128)[:1]]
    else:
        cfg = get_arch("llama2-7b")
        mask = (args.batch, cfg.n_heads, args.seq, args.seq)
        cells = [("llama2-7b", d, False, mask, c) for d in dtypes
                 for c in search.gemm_cells_for_arch(
                     "llama2-7b", args.batch, args.seq, reduced=False)]
    for arch, dtype, reduced, mask, (site, gemm) in cells:
        t = search.tune_cell(arch, site, gemm, mask, hw_for(dtype),
                             max_gate_runs=6 if args.smoke else 12,
                             dtype=dtype, device=device, reduced=reduced)
        tunings.append(t)
        _log(f"{arch}/{site}/{dtype} {gemm}: {t.default.blocks} "
             f"mc{t.default.mask_cols} -> {t.tuned.blocks} "
             f"mc{t.tuned.mask_cols} (taken {t.accepted}, admitted "
             f"{t.admitted}, gate-rejected {t.rejected})")
        if t.tuned != t.default:
            gemm_blocks[t.gemm] = t.tuned.blocks
            mask_cols[(mask[2], mask[3])] = t.tuned.mask_cols

    # -- 3. resolve the shipped configs' auto sites ------------------------
    cells_out: Dict[str, TunedCell] = {}
    flips = 0
    for arch in list_archs():
        for dtype in dtypes:
            r = site_picks(arch, args.batch, args.seq, dtype, GH100,
                           hw_for(dtype))
            if r is None:
                continue
            default_site, tuned_site, default_s, predicted_s = r
            flips += tuned_site != default_site
            proof = {"verify": True, "forward_bitwise": False}
            for t in tunings:
                if t.arch == arch and t.gemm in gemm_blocks:
                    proof.update(t.proof)
            key = cell_key(arch, args.batch, args.seq, dtype)
            cells_out[key] = TunedCell(
                key=key, site=tuned_site, default_site=default_site,
                predicted_s=predicted_s, default_s=default_s, proof=proof,
                measured_on=f"{arch} b{args.batch} s{args.seq} on {device}")
            _log(f"{arch}/{dtype} @ b{args.batch} s{args.seq}: GH100 "
                 f"{default_site} -> calibrated {tuned_site}"
                 f"{'  [flip]' if tuned_site != default_site else ''}")
    table = TunedTable(calibrations=cals, gemm_blocks=gemm_blocks,
                       mask_cols=mask_cols, cells=cells_out,
                       residuals=residuals)

    # -- 4. prove ----------------------------------------------------------
    failures = 0
    with overlay(table):
        for arch in list_archs():
            cfg = get_arch(arch)
            try:
                sched = compile_schedule(
                    cfg, DropoutPlanConfig(mode="overlap", p=0.1,
                                           site="auto"),
                    args.batch, args.seq, attn_impl="pallas")
                analysis.verify_schedule(cfg, sched,
                                         cell=f"tune-lint:{arch}")
            except Exception as e:
                failures += 1
                _log(f"LINT FAIL {arch}: {type(e).__name__}: {e}")
    _log(f"verifier under the table: {len(list_archs()) - failures} "
         f"schedules proven, {failures} failures")
    if failures:
        return 3
    proven = {}
    for arch in sorted({t.arch for t in tunings}):
        proven[arch], site = forward_bitwise(arch, 2, 128, table, device)
        _log(f"{arch}: reduced forward, site=auto under the table -> "
             f"{site}, against {site} fixed with no table: "
             f"{'bitwise' if proven[arch] else 'MISMATCH'}")
        if not proven[arch]:
            return 4
    for key, c in list(cells_out.items()):
        arch = key.split("|")[0]
        if arch in proven:
            cells_out[key] = TunedCell(
                key=c.key, site=c.site, default_site=c.default_site,
                predicted_s=c.predicted_s, default_s=c.default_s,
                proof={**c.proof, "forward_bitwise": proven[arch]},
                measured_on=c.measured_on)
    table.cells = cells_out

    # -- 5. persist --------------------------------------------------------
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    table.save(out)
    _log(f"wrote {out}: {len(gemm_blocks)} gemm shapes, {len(cells_out)} "
         f"cells, {flips} site flips, calibrations {sorted(cals)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
