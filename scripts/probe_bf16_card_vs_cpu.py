#!/usr/bin/env python3
"""The smoke's bf16-compute card-against-CPU training runs (phase 4 of
``chip_smoke.py``), each run's distance from its limits, for one
checkout or several. A probe, not part of the port.

Phase 4 holds 3 ``make_train_step`` steps of each reduced model on the
card against the same steps on the CPU. At bf16 compute the MoE runs sit
near their limits: the router's top-k turns a one-ulp difference of the
card's bf16 GEMMs into another expert, and AdamW turns a flipped
near-zero gradient into a full-rate step, so any change to the block's
bf16 roundings moves them. This probe runs every bf16-compute run of
phase 4 (the reduced llama2 and yi at qkv/bf16; moonshot, arctic and the
RWKV hybrid at ffn_up/bf16 and ffn_down/fp8; fused mode on llama2 and
moonshot under both attention impls; the reduced recurrentgemma at
ffn_up/bf16) with each checkout's own ``chip_smoke.py`` and ``src/``, in
one child process a checkout, and prints for each run the smoke's line
(the measured differences and their shares of the limits) or the step at
which it failed its limits; it goes on past a failure.

    python3 scripts/probe_bf16_card_vs_cpu.py [--roots DIR ...]

Each DIR is the root of a checkout (``git archive <commit> | tar -x -C
DIR``, DIR under ``build/``); without ``--roots``, this checkout alone.
Needs one NVIDIA GPU and nvcc; each child builds its checkout's kernels
into that checkout's ``build/`` (phase 1) and prints the card's name and
power limit (phase 0).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def bf16_runs(s):
    """(label, thunk) for every bf16-compute run of phase 4, as
    ``phase_train_reference`` makes them, from ``s`` (a checkout's
    chip_smoke module)."""
    import torch

    from repro_torch.config import get_arch
    from repro_torch.config.base import OptimizerConfig
    from repro_torch.train import init_train_state
    opt = OptimizerConfig(**s.REF_OPT)
    bf16 = torch.bfloat16

    def run(cfg, master, label, run_cfg, **kw):
        return (f"{cfg.name} {label}",
                lambda: s._card_vs_cpu(cfg, run_cfg, master, label,
                                       compute_dtype=bf16, **kw))

    out = []
    for arch in ("llama2-7b", "yi-6b"):
        cfg = get_arch(arch, reduced=True)
        master = init_train_state(cfg, seed=1, device="cpu")["master"]
        out.append(run(cfg, master, "qkv/bf16 attn_replay=auto",
                       s._train_run(cfg, "auto", 2, 256, opt=opt,
                                    gemm_dtype="bf16")))
    for cfg in (get_arch("moonshot-v1-16b-a3b", reduced=True),
                get_arch("arctic-480b", reduced=True), s.rwkv_hybrid()):
        hybrid = cfg.moe is None
        master = init_train_state(cfg, seed=1, device="cpu")["master"]
        for site, dtype in (("ffn_up", "bf16"), ("ffn_down", "fp8")):
            out.append(run(
                cfg, master, f"{site}/{dtype} attn_replay=off",
                s._train_run(cfg, "off", 2, 256, opt=opt, site=site,
                             gemm_dtype=dtype),
                bf16_tols=(s.HYBRID_BF16_TOLS if hybrid
                           else s.BF16_REF_TOLS),
                change_rel=(s.HYBRID_BF16_CHANGE_REL if hybrid
                            else s.REF_CHANGE_REL)))
    for arch in ("llama2-7b", "moonshot-v1-16b-a3b"):
        cfg = get_arch(arch, reduced=True)
        master = init_train_state(cfg, seed=1, device="cpu")["master"]
        for impl in ("pallas", "xla"):
            moe_xla = cfg.moe is not None and impl == "xla"
            out.append(run(
                cfg, master, f"fused attn_impl={impl}",
                s._train_run(cfg, "auto", 2, 256, opt=opt, site="xla",
                             mode="fused", impl=impl),
                bf16_tols=(s.MOE_XLA_BF16_TOLS if moe_xla
                           else s.BF16_REF_TOLS)))
    cfg = get_arch("recurrentgemma-9b", reduced=True)
    master = init_train_state(cfg, seed=1, device="cpu")["master"]
    out.append(run(cfg, master, "ffn_up/bf16 attn_replay=off",
                   s._train_run(cfg, "off", 2, 256, opt=opt, site="ffn_up",
                                gemm_dtype="bf16")))
    return out


def child(root: Path) -> int:
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as s
    state = {"philox_err": 0}
    s.phase_card(state)
    s.phase_build(state)
    failed = 0
    for label, thunk in bf16_runs(s):
        t0 = time.perf_counter()
        try:
            thunk()
        except AssertionError as err:
            failed += 1
            print(f"[probe] {root.name}: {label} FAILED: {err} | "
                  f"{state['smi']}", flush=True)
        print(f"[probe] {root.name}: {label} done in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[probe] {root.name}: {failed} run(s) failed their limits | "
          f"{state['smi']}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="*", default=[str(ROOT)])
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(Path(args.child).resolve())
    rc = 0
    for root in args.roots:
        print(f"[probe] checkout {root}", flush=True)
        rc |= subprocess.run([sys.executable, __file__, "--child",
                              root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
