"""Serving CLI — a thin front over the port's decode engine:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --requests 8 --prompt-len 256 --max-new 64

Runs on the GPU (``--device cuda``, the default) with random weights from
``--seed``; ``--device cpu`` runs the same engine on the CPU. Prints the
``ServeReport``.
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np


def main() -> None:
    from repro_torch.config import get_arch
    from repro_torch.serve import ServeConfig, ServeEngine

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="0 = sized for max_slots full-length requests")
    ap.add_argument("--max-model-len", type=int, default=0,
                    help="0 = round up prompt+max_new")
    ap.add_argument("--no-mask", action="store_true",
                    help="disable decode-time dropout rows")
    ap.add_argument("--json", action="store_true",
                    help="print the ServeReport as JSON")
    args = ap.parse_args()

    cfg = get_arch(args.arch, reduced=args.reduced)
    cap = args.prompt_len + args.max_new
    # max_model_len must divide into pages AND packed mask rows
    quantum = 32 * args.page_size // math.gcd(32, args.page_size)
    max_len = args.max_model_len or cap
    max_len = -(-max_len // quantum) * quantum
    num_pages = args.num_pages or (
        args.max_slots * -(-max_len // args.page_size) + args.max_slots)
    serve = ServeConfig(
        max_slots=args.max_slots, page_size=args.page_size,
        num_pages=num_pages, max_model_len=max_len,
        mask_decode=not args.no_mask)
    engine = ServeEngine(cfg, serve=serve, init_seed=args.seed,
                         device=args.device)
    print(f"[serve] arch={cfg.name} device={engine.device} "
          f"slots={serve.max_slots} pages={serve.num_pages}x"
          f"{serve.page_size} max_len={serve.max_model_len} "
          f"masked={engine.masked}")

    rng = np.random.default_rng(args.seed)
    requests = [
        engine.make_request(
            prompt=rng.integers(0, cfg.vocab_size,
                                args.prompt_len).tolist(),
            max_new_tokens=args.max_new)
        for _ in range(args.requests)
    ]
    report = engine.run(requests)
    d = report.to_dict()
    if args.json:
        print(json.dumps(d, indent=2, default=str))
        return
    print(f"[serve] {d['n_requests']} requests, "
          f"{d['total_new_tokens']} new tokens in {d['wall_s']:.2f}s "
          f"({d['tokens_per_s']:,.1f} tok/s)")
    print(f"[serve] first-token p50="
          f"{d['latency_first_token_s']['p50'] * 1e3:.0f}ms "
          f"p99={d['latency_first_token_s']['p99'] * 1e3:.0f}ms; "
          f"completion p50={d['latency_completion_s']['p50'] * 1e3:.0f}ms")
    mc = d["mask_cache"]
    print(f"[serve] mask cache: {mc['hits']} hits / {mc['misses']} "
          f"Philox execs / {mc['evictions']} evictions")
    print(f"[serve] schedule cache: {d['schedule_cache']}")


if __name__ == "__main__":
    main()
