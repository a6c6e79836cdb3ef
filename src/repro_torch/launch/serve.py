"""Online serving launcher for the port (counterpart of
`python -m repro.launch.serve --online`).

    # on the card (default device): full Ling-Lite, random weights
    PYTHONPATH=src python -m repro_torch.launch.serve --online \
        --slots 8 --prefill-chunk 64 --seq 512 --prompt-len 128 \
        --max-new 32 --requests 16 --rates 64

    # plain PyTorch path on the CPU at smoke size
    PYTHONPATH=src python -m repro_torch.launch.serve --online --smoke \
        --device cpu --rates 4,16 --requests 8 --max-new 8

Builds a Runner with random weights (`Runner.init_params(0)`), an
`OnlineEngine` over a paged KV pool, eats the first-call costs (kernel
build, allocator warm-up) with a small warm-up load, then reports one
Poisson load per `--rates` entry: tok/s, TTFT and inter-token latency
percentiles.
"""
from __future__ import annotations

import argparse

from repro_torch import api
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.serving.online import (OnlineConfig, OnlineEngine,
                                        run_poisson_load)


def run_online(cfg, args) -> list:
    runner = api.Runner(cfg, device=args.device)
    params = runner.init_params(0)
    ocfg = OnlineConfig(max_slots=args.slots, max_context=args.seq,
                        page_size=args.page_size, n_pages=args.pages,
                        prefill_chunk=args.prefill_chunk)
    eng = OnlineEngine(runner, params, ocfg)
    run_poisson_load(eng, rate=100.0, n_requests=2,
                     prompt_len=args.prompt_len, max_new=2,
                     vocab_size=cfg.vocab_size, seed=7)
    reports = []
    for rate in (float(r) for r in args.rates.split(",")):
        rep = run_poisson_load(eng, rate=rate, n_requests=args.requests,
                               prompt_len=args.prompt_len,
                               max_new=args.max_new,
                               vocab_size=cfg.vocab_size)
        # greedy slice: no admission gate (shed=0), no speculation (acc=0)
        print(f"[online] rate={rate:g}/s tok/s={rep['tok_s']:.1f} "
              f"ttft p50/p99={rep['ttft_p50_ms']:.0f}/"
              f"{rep['ttft_p99_ms']:.0f}ms itl p50/p99="
              f"{rep['itl_p50_ms']:.1f}/{rep['itl_p99_ms']:.1f}ms "
              f"preempts={rep['preemptions']} shed=0 acc=0.00 "
              f"ticks/tok={rep['decode_ticks_per_token']:.2f} "
              f"prefix_hit_rate={rep['prefix_hit_rate']:.2f}")
        reports.append(rep)
    return reports


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ling-lite")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--online", action="store_true",
                    help="continuous-batching engine + Poisson load "
                         "generator (the only mode ported so far)")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size in tokens")
    ap.add_argument("--pages", type=int, default=None,
                    help="physical page pool size (default: every slot can "
                         "hold a full --seq context)")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prompt tokens prefilled per tick")
    ap.add_argument("--seq", type=int, default=128,
                    help="max context (prompt + generation) per request")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--rates", default="4,16",
                    help="comma-separated Poisson arrival rates (req/s), one "
                         "load run each")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (plain PyTorch)")
    args = ap.parse_args(argv)
    if not args.online:
        raise SystemExit("only --online serving is ported to repro_torch; "
                         "the offline Flood engine arrives later")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    run_online(cfg, args)


if __name__ == "__main__":
    main()
