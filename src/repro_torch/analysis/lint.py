"""Config-sweep CLI of the static mask-safety verifier.

    PYTHONPATH=src python -m repro_torch.analysis.lint             # all cells
    PYTHONPATH=src python -m repro_torch.analysis.lint --config yi-6b \\
        --site auto --dtype fp8 --topologies 1,2
    PYTHONPATH=src python -m repro_torch.analysis.lint --mutate counter-overlap

Per cell (config x site x gemm_dtype x topology) Layer 1, the counter
layer, runs on the full-size architecture at DEFAULT_BATCH x DEFAULT_SEQ:
integer arithmetic over the compiled schedule and the port's kernel walks
(``counters``), nothing traced, built or launched. Layer 2, the dataflow
walk (``dataflow``), traces the reduced same-family config once per
(config, site) on fake tensors -- ``--jaxpr`` keeps the JAX package's
flag name, and walks the FX graph of the forward and of its gradient:
``auto`` once per (config, site), ``all`` per dtype too, ``off`` skips it.
``site="auto"`` cells are planned by the perf model and proven like any
other. The flags are the JAX package's (``python -m repro.analysis.lint``).

Exit codes: 0 every linted cell clean; 1 findings (each printed with its
rule ID), or an injected mutation caught by the rule JAX's lint names for
it; 2 a usage error, or a mutation that slipped past the analyzer.
Nothing executes a kernel in any mode.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.analysis import counters, dataflow, rules
from repro_torch.config.base import (
    DROPOUT_SITES,
    GEMM_DTYPES,
    DropoutPlanConfig,
)
from repro_torch.config.registry import get_arch, list_archs
from repro_torch.core.schedule import ShardInfo, compile_schedule

# counter-space analysis shape: multi-step emission grids and MoE capacity
# arithmetic, small enough to sweep every shipped config in seconds
DEFAULT_BATCH = 8
DEFAULT_SEQ = 1024
# dataflow trace shape (reduced configs)
JAXPR_BATCH = 2
JAXPR_SEQ = 256

MUTATIONS = ("counter-overlap", "emission-gap", "shard-window",
             "stride", "residual-leak", "reshard-window",
             "replay-counter-drift", "cta-run-shift", "philox-stride",
             "replay-tile-row")
_MUTATION_RULE = {
    "counter-overlap": rules.COUNTER_OVERLAP,
    "emission-gap": rules.EMISSION_GAP,
    "shard-window": rules.SHARD_WINDOW_MISMATCH,
    "stride": rules.STRIDE_MISMATCH,
    "residual-leak": rules.MASK_RESIDUAL_LEAK,
    "reshard-window": rules.SHARD_WINDOW_MISMATCH,
    # a drifted replay consumer no longer coincides with the planned
    # draw: the target's counter window is drawn twice -> MS-C1
    "replay-counter-drift": rules.COUNTER_OVERLAP,
    # the port's kernel walks: a CTA run one word on re-draws the next
    # run's first word; a Philox stride one past the grid's threads never
    # draws the groups of one residue; a replay tile one packed row down
    # re-draws the row below it
    "cta-run-shift": rules.COUNTER_OVERLAP,
    "philox-stride": rules.EMISSION_GAP,
    "replay-tile-row": rules.COUNTER_OVERLAP,
}
# the site a mutation lints when none is given: JAX's lint takes "auto",
# which resolves to "ffn_up" on its default cell (yi-6b at 8 x 1024) under
# its TPU constants; the port's mutations pin that site
MUTATION_SITE = "ffn_up"


def topology_shards(devices: int) -> List[ShardInfo]:
    """The mask-plane shard layouts a ``devices``-wide mesh can realize:
    batch split over a data axis, and heads split over a model axis (the
    layout whose host GEMM is N-dim sharded). devices=1 is the unsharded
    layout. Pure arithmetic: no mesh is needed."""
    if devices <= 1:
        return [ShardInfo()]
    return [
        ShardInfo(batch_shards=devices, batch_axes=("data",),
                  policy_installed=True),
        ShardInfo(head_shards=devices, head_axes=("model",),
                  policy_installed=True),
    ]


def _plan(site: str, dtype: str, replay: str = "auto") -> DropoutPlanConfig:
    return DropoutPlanConfig(mode="overlap", p=0.1, site=site,
                             gemm_dtype=dtype, attn_replay=replay)


def lint_cell(arch: str, site: str, dtype: str, *, batch: int,
              seq: int, shard: Optional[ShardInfo] = None
              ) -> Optional[rules.Report]:
    """Layer-1 verdict for one (config, site, dtype[, topology]) cell on
    the full-size architecture. None = the topology cannot shard this
    cell's mask plane (a dim does not divide): skipped, not clean."""
    cfg = get_arch(arch)
    cell = f"{arch} site={site} dtype={dtype}"
    if shard is not None and shard.active:
        if (batch % shard.batch_shards) or (cfg.n_heads %
                                            shard.head_shards):
            return None
        axes = shard.batch_axes + shard.head_axes
        cell += (f" topo={shard.batch_shards}x{shard.head_shards}"
                 f"({','.join(axes)})")
    sched = compile_schedule(cfg, _plan(site, dtype), batch, seq,
                             attn_impl="pallas", shard=shard)
    return counters.analyze_schedule(cfg, sched, cell=cell)


def lint_cell_jaxpr(arch: str, site: str, dtype: str) -> rules.Report:
    """Layer-2 verdict (the dataflow walk) on the reduced config."""
    cfg = get_arch(arch, reduced=True)
    return dataflow.analyze_model(
        cfg, _plan(site, dtype), JAXPR_BATCH, JAXPR_SEQ,
        attn_impl="pallas", device="cpu",
        cell=f"{arch}[reduced] site={site} dtype={dtype}")


def _run_mutation(kind: str, arch: str, site: str, dtype: str,
                  batch: int, seq: int) -> int:
    """Corrupt one cell and demand the matching rule fires. Returns the
    process exit code: 1 when the corruption is caught (a genuine lint
    failure, named), 2 when it slipped past the analyzer."""
    want = _MUTATION_RULE[kind]
    if kind == "residual-leak":
        rep = dataflow.analyze_leaky_model(
            get_arch(arch, reduced=True), _plan(site, dtype), JAXPR_BATCH,
            JAXPR_SEQ, device="cpu")
        return _verdict(rep, kind, want)
    cfg = get_arch(arch)
    # reshard-window needs a sharded schedule (a 2-way model-axis
    # topology); philox-stride a standalone emission (premask
    # consumption, whose carried sites bootstrap from the Philox kernel)
    shard = topology_shards(2)[1] if kind == "reshard-window" else None
    replay = "off" if kind == "philox-stride" else "auto"
    sched = compile_schedule(cfg, _plan(site, dtype, replay), batch, seq,
                             attn_impl="pallas", shard=shard)
    if kind == "stride":
        sched = counters.corrupt_schedule_stride(sched)
        emissions = counters.schedule_emissions(cfg, sched)
    else:
        emissions = counters.corrupt_emissions(
            counters.schedule_emissions(cfg, sched), kind)
    rep = rules.Report(
        cell=f"{arch} site={site} dtype={dtype} mutate={kind}",
        findings=tuple(counters.check_emissions(cfg, sched, emissions)),
        checked_emissions=len(emissions))
    return _verdict(rep, kind, want)


def _verdict(rep: rules.Report, kind: str, want: str) -> int:
    print(rep.render())
    if any(f.rule == want for f in rep.findings):
        print(f"[lint] mutation {kind!r} caught by {want}")
        return 1
    print(f"[lint] mutation {kind!r} NOT caught (wanted {want}) -- "
          "verifier regression")
    return 2


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="static mask-safety lint (counter layer) over compiled "
                    "DropoutSchedules, proven over the port's kernel walks")
    ap.add_argument("--config", default=None,
                    help="arch id (default: every shipped config)")
    ap.add_argument("--site", default=None, choices=DROPOUT_SITES,
                    help="producer site (default: sweep all)")
    ap.add_argument("--dtype", default=None, choices=GEMM_DTYPES,
                    help="host GEMM dtype (default: sweep all)")
    ap.add_argument("--batch", type=int, default=DEFAULT_BATCH)
    ap.add_argument("--seq", type=int, default=DEFAULT_SEQ)
    ap.add_argument("--jaxpr", default="auto",
                    choices=("auto", "off", "all"),
                    help="Layer 2, the dataflow walk over the FX graph of "
                         "the forward and its gradient (the JAX flag's "
                         "name): once per (config, site) [auto], per dtype "
                         "[all], or skipped")
    ap.add_argument("--mutate", default=None, choices=MUTATIONS,
                    help="inject one corruption; exit 1 iff the matching "
                         "rule catches it")
    ap.add_argument("--topologies", default="1",
                    help="comma-separated mesh widths to lint each cell "
                         "under (e.g. 1,2): width t>1 re-lints on a "
                         "t-way data-axis and a t-way model-axis layout")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print failing cells only")
    args = ap.parse_args(argv)
    try:
        topologies = [int(t) for t in args.topologies.split(",") if t]
        if not topologies or min(topologies) < 1:
            raise ValueError
    except ValueError:
        ap.error(f"--topologies {args.topologies!r}: expected "
                 "comma-separated positive ints")

    archs = [args.config] if args.config else list_archs()
    sites = [args.site] if args.site else list(DROPOUT_SITES)
    dtypes = [args.dtype] if args.dtype else list(GEMM_DTYPES)

    if args.mutate:
        return _run_mutation(args.mutate, archs[0],
                             args.site or MUTATION_SITE, dtypes[0],
                             args.batch, args.seq)

    shards = [s for t in sorted(set(topologies))
              for s in topology_shards(t)]
    bad = cells = skipped = 0
    for arch in archs:
        for site in sites:
            for di, dtype in enumerate(dtypes):
                reps = [lint_cell(arch, site, dtype, batch=args.batch,
                                  seq=args.seq, shard=shard)
                        for shard in shards]
                if args.jaxpr == "all" or (args.jaxpr == "auto"
                                           and di == 0):
                    reps.append(lint_cell_jaxpr(arch, site, dtype))
                for rep in reps:
                    if rep is None:      # topology can't tile the plane
                        skipped += 1
                        continue
                    cells += 1
                    if not rep.ok:
                        bad += 1
                    if not rep.ok or not args.quiet:
                        print(rep.render())
    skip = f", {skipped} skipped (indivisible topology)" if skipped else ""
    print(f"[lint] {cells} cells, {bad} with findings{skip}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
