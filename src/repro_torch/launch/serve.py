"""Serving launcher for the port (counterpart of `python -m
repro.launch.serve`): offline (Flood) and online continuous-batching
modes.

    # offline, on the card (default device): full rwkv6-3b, random weights
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --requests 16 --max-new 32 --microbatch 8

    # offline, plain PyTorch path on the CPU at smoke size
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --smoke --device cpu --requests 4 --max-new 8

    # online, on the card: full Ling-Lite, random weights
    PYTHONPATH=src python -m repro_torch.launch.serve --online \
        --slots 8 --prefill-chunk 64 --seq 512 --prompt-len 128 \
        --max-new 32 --requests 16 --rates 64

    # plain PyTorch path on the CPU at smoke size
    PYTHONPATH=src python -m repro_torch.launch.serve --online --smoke \
        --device cpu --rates 4,16 --requests 8 --max-new 8

    # sampled, speculative (a 1-layer self-draft, 4 drafts a tick), with
    # a bounded queue that sheds and two tenants' budgets
    PYTHONPATH=src python -m repro_torch.launch.serve --online --smoke \
        --device cpu --temperature 0.8 --top-p 0.95 --top-k 64 --seed 1 \
        --spec-k 4 --draft-layers 1 --policy decode-priority \
        --max-queue 8 --overload shed --tenant-budgets a:256,b:256

Offline builds a Runner with random weights (`Runner.init_params(0)`)
and drives the FloodEngine (segment KV cache, S+1 in-flight
micro-batches) on the sampled dense decode step (rwkv models);
`--baseline` runs the synchronous global-batch engine instead.  Online
builds an `OnlineEngine` over a paged KV pool (all-attn models), eats
the first-call costs (kernel build, allocator warm-up) with a small
warm-up load, then reports one Poisson load per `--rates` entry: tok/s,
TTFT and inter-token latency percentiles.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.serving.draft import (ConfigDrafter, SelfDrafter,
                                       adapt_drafter_config)
from repro_torch.serving.flood import (FloodEngine, GenRequest,
                                       baseline_step_engine)
from repro_torch.serving.online import (OnlineConfig, OnlineEngine,
                                        run_poisson_load)
from repro_torch.serving.segment_cache import SegmentCache


def build_model_engine(runner, params, n_stages: int, batch: int,
                       temperature: float = 0.0, top_p: float = 1.0,
                       top_k: int = 0, seed: int = 0):
    """Real-model Flood engine on the sampled dense decode step (the
    reference's `build_model_engine`, which draws its parameters inside;
    this one takes them, and needs no cache length: rwkv state does not
    grow).  Returns (embed_fn, stage_fns, head_fn).

    Reproduces the reference as written: the stages pass activations
    through and the head runs the whole model's decode step; each request
    feeds its last output token, or its last prompt token before it has
    one; one cache and one position counter are shared by every in-flight
    micro-batch; and request rid draws under seed (seed + rid) % 2**31
    with the online engine's (seed, position, stream) keys (temperature
    0 is the greedy token bit for bit)."""
    decode = runner.make_decode_step(sample=True)
    dev = runner.device
    state = {"caches": runner.init_caches(batch), "pos": 0}
    knobs = (torch.full((batch,), temperature, dtype=torch.float32,
                        device=dev),
             torch.full((batch,), top_p, dtype=torch.float32, device=dev),
             torch.full((batch,), top_k, dtype=torch.int64, device=dev))

    def embed_fn(reqs):
        toks = np.zeros((batch,), np.int32)
        seeds = np.zeros((batch,), np.int64)
        for i, r in enumerate(reqs[:batch]):
            toks[i] = (r.out[-1] if r.out else r.prompt[-1])
            seeds[i] = (seed + r.rid) % (2 ** 31)
        return {"tokens": torch.from_numpy(toks).to(dev),
                "seeds": torch.from_numpy(seeds).to(dev),
                "reqs": len(reqs)}

    def stage_fn(_i):
        def fn(x):
            return x  # layer stages fused into head_fn for the real model
        return fn

    def head_fn(x, reqs):
        nxt, state["caches"] = decode(params, state["caches"], x["tokens"],
                                      state["pos"], x["seeds"], *knobs)
        state["pos"] += 1
        return nxt.cpu().numpy()[:len(reqs)]

    return embed_fn, [stage_fn(i) for i in range(n_stages)], head_fn


def make_drafter(cfg, args):
    """The --spec-k / --draft-* flags as a serving.draft drafter (None
    when speculation is off)."""
    if args.spec_k <= 0:
        return None
    if args.draft_arch:
        dcfg = (get_smoke_config(args.draft_arch) if args.smoke
                else get_config(args.draft_arch))
        return ConfigDrafter(adapt_drafter_config(dcfg, cfg))
    return SelfDrafter(draft_layers=args.draft_layers)


def parse_tenant_budgets(spec):
    """'alice:128,bob:64' -> {'alice': 128, 'bob': 64} (None passes
    through)."""
    if not spec:
        return None
    out = {}
    for part in spec.split(","):
        name, _, tokens = part.partition(":")
        if not name or not tokens:
            raise ValueError(f"--tenant-budgets entry {part!r} is not "
                             f"name:tokens")
        out[name] = int(tokens)
    return out


def run_offline(cfg, args):
    """The Flood engine (or `--baseline`) over `--requests` random prompts
    of `--prompt-len` tokens (numpy seed 0).  Returns the PipelineStats."""
    runner = api.Runner(cfg, device=args.device)
    params = runner.init_params(0)
    rs = np.random.RandomState(0)
    reqs = [GenRequest(rid=i,
                       prompt=rs.randint(0, cfg.vocab_size,
                                         args.prompt_len).astype(np.int32),
                       max_new=args.max_new)
            for i in range(args.requests)]
    embed_fn, stage_fns, head_fn = build_model_engine(
        runner, params, args.stages, args.microbatch,
        temperature=args.temperature, top_p=args.top_p, top_k=args.top_k,
        seed=args.seed)
    if args.baseline:
        stats = baseline_step_engine(head_fn, embed_fn, reqs)
    else:
        eng = FloodEngine(stage_fns, head_fn, embed_fn,
                          cache=SegmentCache(max_tokens=1 << 16,
                                             initial_segment=32,
                                             extend_chunk=32),
                          microbatch=args.microbatch)
        eng.submit(reqs)
        stats = eng.run()
        print("cache stats:", eng.cache.stats)
    print(f"tokens={stats.tokens_out} wall={stats.wall_s:.2f}s "
          f"tok/s={stats.tokens_per_s:.1f}")
    return stats


def run_online(cfg, args) -> list:
    runner = api.Runner(cfg, device=args.device)
    params = runner.init_params(0)
    budgets = parse_tenant_budgets(args.tenant_budgets)
    ocfg = OnlineConfig(max_slots=args.slots, max_context=args.seq,
                        page_size=args.page_size, n_pages=args.pages,
                        prefill_chunk=args.prefill_chunk,
                        temperature=args.temperature, top_p=args.top_p,
                        top_k=args.top_k, seed=args.seed,
                        spec_k=args.spec_k,
                        radix_cache=not args.no_radix_cache,
                        policy=args.policy, max_queue=args.max_queue,
                        overload=args.overload, tenant_budgets=budgets)
    eng = OnlineEngine(runner, params, ocfg,
                       drafter=make_drafter(cfg, args))
    run_poisson_load(eng, rate=100.0, n_requests=2,
                     prompt_len=args.prompt_len, max_new=2,
                     vocab_size=cfg.vocab_size, seed=7)
    tenants = list(budgets) if budgets else None
    reports = []
    for rate in (float(r) for r in args.rates.split(",")):
        rep = run_poisson_load(eng, rate=rate, n_requests=args.requests,
                               prompt_len=args.prompt_len,
                               max_new=args.max_new,
                               vocab_size=cfg.vocab_size, tenants=tenants)
        print(f"[online] rate={rate:g}/s tok/s={rep['tok_s']:.1f} "
              f"ttft p50/p99={rep['ttft_p50_ms']:.0f}/"
              f"{rep['ttft_p99_ms']:.0f}ms itl p50/p99="
              f"{rep['itl_p50_ms']:.1f}/{rep['itl_p99_ms']:.1f}ms "
              f"preempts={rep['preemptions']} shed={rep['shed']} "
              f"acc={rep['acceptance_rate']:.2f} "
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
                         "generator (all-attn models); without it the "
                         "offline Flood engine (rwkv models)")
    ap.add_argument("--microbatch", type=int, default=4,
                    help="offline: requests per micro-batch")
    ap.add_argument("--stages", type=int, default=2,
                    help="offline: pipeline stages")
    ap.add_argument("--baseline", action="store_true",
                    help="offline: the synchronous global-batch engine")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = exact greedy)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = off)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation (0 = off)")
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling seed base; request rid r draws under "
                         "seed (seed + r) %% 2**31")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="online: speculative draft length per tick "
                         "(0 = off)")
    ap.add_argument("--draft-layers", type=int, default=1,
                    help="online: self-draft depth (the target's first N "
                         "layers, no new weights)")
    ap.add_argument("--draft-arch", default=None,
                    help="online: a separate small arch as the drafter "
                         "(rewritten by adapt_drafter_config; fresh "
                         "weights)")
    ap.add_argument("--policy", default="fcfs",
                    choices=["fcfs", "decode-priority", "prefill-priority"],
                    help="online: tick-ordering policy")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="online: bound the arrival queue (default "
                         "unbounded)")
    ap.add_argument("--overload", default="defer",
                    choices=["defer", "shed", "slo"],
                    help="online: full-queue response: 'defer' retries "
                         "later, 'shed' drops the request ('slo' is not "
                         "ported yet and raises)")
    ap.add_argument("--tenant-budgets", default=None,
                    help="online: per-tenant admitted-token caps as "
                         "'name:tokens,name:tokens'; the load generator "
                         "deals requests to the named tenants round robin")
    ap.add_argument("--no-radix-cache", action="store_true",
                    help="online: turn off the radix prefix cache (streams "
                         "are identical either way)")
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
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.online:
        return run_online(cfg, args)
    return run_offline(cfg, args)


if __name__ == "__main__":
    main()
