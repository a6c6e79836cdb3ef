"""Serving launcher for the port (counterpart of `python -m
repro.launch.serve`): offline (Flood) and online continuous-batching
modes.

    # offline, on the card (default device): full rwkv6-3b, random weights
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --requests 16 --max-new 32 --microbatch 8

    # offline, plain PyTorch path on the CPU at smoke size
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --smoke --device cpu --requests 4 --max-new 8

    # offline Ling-Lite (the reference's default arch): dense KV caches
    # of --seq positions, of any length
    PYTHONPATH=src python -m repro_torch.launch.serve --arch ling-lite \
        --smoke --device cpu --seq 100

    # offline, the other block families (nemotron-4-15b, h2o-danube-1.8b,
    # recurrentgemma-2b, whisper-tiny): rolling window caches, RG-LRU
    # state, whisper's cross caches zeroed and never prefilled (as the
    # reference's engine); --online refuses them, as the reference does
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
        --smoke --device cpu

    # online, on the card: Ling-Plus at full width, its first 8 of 80
    # layers (~62 GB), or granite-moe-3b-a800m whole
    PYTHONPATH=src python -m repro_torch.launch.serve --online \
        --arch ling-plus --layers 8 --slots 8 --prefill-chunk 64 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.serve --online \
        --arch granite-moe-3b-a800m --slots 8 --prefill-chunk 64 --seq 512

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

    # SLO shedding, a Prometheus scrape and a Chrome trace of the run
    PYTHONPATH=src python -m repro_torch.launch.serve --online --smoke \
        --device cpu --overload slo --slo-ttft-ms 50 --metrics-port 0 \
        --trace-out /tmp/serve_trace.json

    # a (1, 2) mesh: 2 gloo ranks on the CPU, or 2 ranks on the card(s)
    # (NCCL with a card per rank, gloo when they share one); every
    # architecture (the recurrent ones and the block families offline
    # only, as on one rank)
    PYTHONPATH=src python -m repro_torch.launch.serve --online --smoke \
        --device cpu --tp 2
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --arch rwkv6-3b --tp 2
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --arch recurrentgemma-2b --tp 2
    PYTHONPATH=src python -m repro_torch.launch.serve --online --tp 2 \
        --slots 8 --prefill-chunk 64 --seq 512 --prompt-len 128

Offline builds a Runner with random weights (`Runner.init_params(0)`)
and drives the FloodEngine (segment KV cache, S+1 in-flight
micro-batches) on the sampled dense decode step (dense KV caches of
`--seq` positions for attention models, the state of rwkv models);
`--baseline` runs the synchronous global-batch engine instead.  Online
builds an `OnlineEngine` over a paged KV pool (all-attn models), eats
the first-call costs (kernel build, allocator warm-up) with a small
warm-up load, then reports one Poisson load per `--rates` entry: tok/s,
TTFT and inter-token latency percentiles.  `--metrics-port` serves the
engine's registry as a Prometheus scrape while it runs and
`--trace-out` writes its Chrome trace (scheduler phases, slots,
counter tracks) at the end.  `--tp` serves on a (1, tp) mesh, one
process per rank (`launch.mesh.run_ranks`: torchrun's environment where
it is set, else spawned ranks), every rank running the same scheduler,
rank 0 printing; the slots, the prefill chunk and Flood's micro-batch
must divide over tp (`quantize_microbatch`); speculative decoding
(`--spec-k`, the drafter on the same mesh) and `--overload slo` (rank
0's tracker deciding for every rank) run there too:

    PYTHONPATH=src python -m repro_torch.launch.serve --online --smoke \
        --device cpu --tp 2 --spec-k 2 --draft-layers 1
    PYTHONPATH=src python -m repro_torch.launch.serve --online --smoke \
        --device cpu --tp 2 --overload slo --slo-ttft-ms 50
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs.base import cut_depth, get_config, get_smoke_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import model as M
from repro_torch.serving.draft import (ConfigDrafter, SelfDrafter,
                                       adapt_drafter_config)
from repro_torch.serving.flood import (FloodEngine, GenRequest,
                                       baseline_step_engine,
                                       quantize_microbatch)
from repro_torch.serving.online import (OnlineConfig, OnlineEngine,
                                        run_poisson_load)
from repro_torch.serving.segment_cache import SegmentCache
from repro_torch.telemetry import MetricsServer, SLOConfig, write_chrome_trace


def build_model_engine(runner, params, n_stages: int, batch: int,
                       seq_len: Optional[int] = None,
                       temperature: float = 0.0, top_p: float = 1.0,
                       top_k: int = 0, seed: int = 0):
    """Real-model Flood engine on the sampled dense decode step (the
    reference's `build_model_engine`, which draws its parameters inside;
    this one takes them).  `seq_len` is the dense KV caches' length, of
    any length (attention layers; recurrent state does not grow and
    ignores it).  Returns (embed_fn, stage_fns, head_fn).

    Reproduces the reference as written: the stages pass activations
    through and the head runs the whole model's decode step; each request
    feeds its last output token, or its last prompt token before it has
    one; one cache and one position counter are shared by every in-flight
    micro-batch, and once the counter passes seq_len nothing more is
    written and every cached position is attended (the reference's
    overflow branch); an encoder-decoder's cross caches stay zero (no
    frames, no prefill); and request rid draws under seed (seed + rid) %
    2**31 with the online engine's (seed, position, stream) keys
    (temperature 0 is the greedy token bit for bit)."""
    decode = runner.make_decode_step(sample=True)
    dev = runner.device
    state = {"caches": runner.init_caches(batch, seq_len), "pos": 0}
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


def run_flags(args) -> M.RunFlags:
    return M.RunFlags(moe_dispatch=args.moe_dispatch,
                      paged_attn=args.paged_attn)


def make_runner(cfg, args, mesh):
    runner = api.Runner(cfg, flags=run_flags(args),
                        device=mesh.device if mesh.size > 1 else args.device,
                        mesh=mesh)
    if mesh.size > 1:
        print(f"[serve] {mesh.describe()}")
    return runner


def run_offline(cfg, args, mesh):
    """The Flood engine (or `--baseline`) over `--requests` random prompts
    of `--prompt-len` tokens (numpy seed 0), on micro-batches of
    `--microbatch` rounded up to a multiple of tp.  Returns the
    PipelineStats."""
    runner = make_runner(cfg, args, mesh)
    params = runner.init_params(0)
    micro = quantize_microbatch(args.microbatch, mesh.tp)
    rs = np.random.RandomState(0)
    reqs = [GenRequest(rid=i,
                       prompt=rs.randint(0, cfg.vocab_size,
                                         args.prompt_len).astype(np.int32),
                       max_new=args.max_new)
            for i in range(args.requests)]
    embed_fn, stage_fns, head_fn = build_model_engine(
        runner, params, args.stages, micro, args.seq,
        temperature=args.temperature, top_p=args.top_p, top_k=args.top_k,
        seed=args.seed)
    if args.baseline:
        stats = baseline_step_engine(head_fn, embed_fn, reqs)
    else:
        eng = FloodEngine(stage_fns, head_fn, embed_fn,
                          cache=SegmentCache(max_tokens=1 << 16,
                                             initial_segment=32,
                                             extend_chunk=32),
                          microbatch=micro, batch_multiple=mesh.tp)
        eng.submit(reqs)
        stats = eng.run()
        print("cache stats:", eng.cache.stats)
    print(f"tokens={stats.tokens_out} wall={stats.wall_s:.2f}s "
          f"tok/s={stats.tokens_per_s:.1f}")
    return stats


def run_online(cfg, args, mesh) -> list:
    """Online continuous batching under a Poisson load at each rate;
    returns the load reports."""
    runner = make_runner(cfg, args, mesh)
    params = runner.init_params(0)
    budgets = parse_tenant_budgets(args.tenant_budgets)
    slo = None
    if args.overload == "slo":
        if args.slo_ttft_ms is None:
            raise SystemExit("--overload slo requires --slo-ttft-ms "
                             "(and optionally --slo-itl-ms)")
        slo = SLOConfig(ttft_p99_ms=args.slo_ttft_ms,
                        itl_p99_ms=args.slo_itl_ms)
    ocfg = OnlineConfig(max_slots=args.slots, max_context=args.seq,
                        page_size=args.page_size, n_pages=args.pages,
                        prefill_chunk=args.prefill_chunk,
                        temperature=args.temperature, top_p=args.top_p,
                        top_k=args.top_k, seed=args.seed,
                        spec_k=args.spec_k,
                        radix_cache=not args.no_radix_cache,
                        policy=args.policy, max_queue=args.max_queue,
                        overload=args.overload, tenant_budgets=budgets,
                        slo=slo)
    eng = OnlineEngine(runner, params, ocfg,
                       drafter=make_drafter(cfg, args))
    server = None
    if args.metrics_port is not None:
        # a point-in-time Prometheus scrape on a background daemon thread;
        # port 0 binds an ephemeral port
        server = MetricsServer(eng.registry, port=args.metrics_port)
        print(f"[online] metrics -> "
              f"http://127.0.0.1:{server.start()}/metrics")
    run_poisson_load(eng, rate=100.0, n_requests=2,
                     prompt_len=args.prompt_len, max_new=2,
                     vocab_size=cfg.vocab_size, seed=7)
    tenants = list(budgets) if budgets else None
    reports = []
    for rate in (float(r) for r in args.rates.split(",")):
        rep = run_poisson_load(eng, rate=rate, n_requests=args.requests,
                               prompt_len=args.prompt_len,
                               max_new=args.max_new,
                               vocab_size=cfg.vocab_size,
                               shared_prefix_len=args.shared_prefix_len,
                               tenants=tenants)
        print(f"[online] rate={rate:g}/s tok/s={rep['tok_s']:.1f} "
              f"ttft p50/p99={rep['ttft_p50_ms']:.0f}/"
              f"{rep['ttft_p99_ms']:.0f}ms itl p50/p99="
              f"{rep['itl_p50_ms']:.1f}/{rep['itl_p99_ms']:.1f}ms "
              f"preempts={rep['preemptions']} shed={rep['shed']} "
              f"acc={rep['acceptance_rate']:.2f} "
              f"ticks/tok={rep['decode_ticks_per_token']:.2f} "
              f"prefix_hit_rate={rep['prefix_hit_rate']:.2f}")
        if rep["slo"] is not None:
            print(f"[online] slo {rep['slo']}")
        reports.append(rep)
    if args.report and mesh.rank == 0:
        with open(args.report, "w") as f:
            json.dump({"bench": "online continuous-batching serving (paged "
                                "KV), PyTorch port",
                       "arch": cfg.arch_id + (" smoke" if args.smoke else ""),
                       "device": str(runner.device),
                       "engine": {"max_slots": ocfg.max_slots,
                                  "page_size": ocfg.page_size,
                                  "n_pages": ocfg.pool_pages(),
                                  "prefill_chunk": ocfg.prefill_chunk,
                                  "max_context": ocfg.max_context,
                                  "moe_dispatch": args.moe_dispatch,
                                  "paged_attn": args.paged_attn},
                       "rates": [{k: v for k, v in r.items()
                                  if k not in ("prompts", "outputs")}
                                 for r in reports]}, f, indent=1)
        print(f"[online] report -> {args.report}")
    if args.trace_out and mesh.rank == 0:
        n = write_chrome_trace(args.trace_out, timer=eng.timer,
                               request_log=eng.rlog, registry=eng.registry)
        print(f"[online] trace ({n} events) -> {args.trace_out} "
              f"(open at https://ui.perfetto.dev)")
    if server is not None:
        if args.metrics_hold > 0:
            # keep /metrics up after the loads drain, for a scrape of the
            # finished run
            print(f"[online] holding /metrics for {args.metrics_hold:g}s")
            time.sleep(args.metrics_hold)
        server.stop()
    return reports


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ling-lite")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the arch's first N layers at full width "
                         "(Ling-Plus's 80 do not fit one card; 8 do)")
    ap.add_argument("--online", action="store_true",
                    help="continuous-batching engine + Poisson load "
                         "generator (all-attn models); without it the "
                         "offline Flood engine")
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
                         "later, 'shed' drops the request; 'slo' sheds "
                         "whenever the windowed latency view says admitting "
                         "would breach --slo-ttft-ms/--slo-itl-ms")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="online: windowed p99 TTFT deadline for "
                         "--overload slo (milliseconds)")
    ap.add_argument("--slo-itl-ms", type=float, default=None,
                    help="online: optional windowed p99 inter-token "
                         "latency deadline for --overload slo")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="online: serve a Prometheus text scrape at "
                         "http://127.0.0.1:PORT/metrics on a background "
                         "thread (0 = ephemeral port)")
    ap.add_argument("--metrics-hold", type=float, default=0.0,
                    help="online: keep /metrics up for SECONDS after the "
                         "loads finish")
    ap.add_argument("--trace-out", default=None,
                    help="online: write a Chrome trace-event JSON of the "
                         "run (scheduler phases, slots, counter tracks), "
                         "viewable at https://ui.perfetto.dev")
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
                    help="online: max context (prompt + generation) per "
                         "request; offline: the dense KV caches' length")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--rates", default="4,16",
                    help="comma-separated Poisson arrival rates (req/s), one "
                         "load run each")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="online: tokens of shared system prompt per "
                         "request (0 = disjoint prompts)")
    ap.add_argument("--report", default=None,
                    help="online: write the load reports as JSON here")
    ap.add_argument("--moe-dispatch", default="auto",
                    choices=["auto", "fused", "ragged", "batched", "ep"],
                    help="MoE dispatch: fused (K1), the plain ragged "
                         "composition or the per-expert-capacity batched "
                         "einsums; 'ep' (the expert-parallel all-to-all, "
                         "K1 on each shard) is 'fused' at tp=1; 'auto' is "
                         "'fused' at tp=1, at tp > 1 'ep', or 'batched' "
                         "where the tokens do not divide over tp")
    ap.add_argument("--tp", type=int, default=1,
                    help="serve on a (1, tp) mesh, one process per rank")
    ap.add_argument("--paged-attn", default="auto",
                    choices=["auto", "fused", "gathered"],
                    help="paged and dense attention: 'fused' (K3/K4, the "
                         "default) or the 'gathered' plain combine")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (plain PyTorch)")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cut_depth(cfg, args.layers)
    if args.tp < 1:
        ap.error("--tp takes a size >= 1")
    return run_ranks(serve_rank, 1, args.tp, args.device, cfg, args)


def serve_rank(mesh, cfg, args):
    """One rank's run (the whole run at tp=1)."""
    if args.online:
        return run_online(cfg, args, mesh)
    return run_offline(cfg, args, mesh)


if __name__ == "__main__":
    main()
