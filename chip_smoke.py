#!/usr/bin/env python3
"""Chip smoke test for the PyTorch/CUDA port (`src/repro_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py     # every phase, in order (needs one card)

Phases, each failing loudly (non-zero exit, no result line):
  1. the card: name and power limit (nvidia-smi), torch / CUDA versions;
  2. build every kernel from src/repro_torch/kernels/csrc with nvcc for
     sm_90a (one nvcc per source, in parallel), timed;
  3. per-kernel checks at Ling-Lite shapes against their plain PyTorch
     versions on identical inputs, with error, tolerance, median
     CUDA-event times, the roofline bound (3.35 TB/s; 989 TFLOP/s bf16)
     and, where one PyTorch call computes the same function, its time
     (every kernel's `ms`: the wrapper from an idle queue, host dispatch
     included):
     K1 fused MoE FFN (T=8 decode, T=64 prefill, T=40 a k=4 verify pass,
     T=2048 training, routing
     from a random router; the path each shape takes, the wrapper's time
     and the C entry's alone, split by kernel with torch.profiler), K3/K4
     paged attention (PA_CASES: decode B=8 Q=1 with 2 inactive slots and
     unallocated pages on the scratch page; verify B=8 Q=5 at the same
     contexts; prefill B=1 Q=64; beside
     `ms`, the card's time for the call enqueued behind a sleep kernel
     and the wrapper's host dispatch alone, which is longer than the
     kernel), K2 grouped matmul at the MoE backward's shapes (12288
     routed rows over 64 experts: the up product 2048 -> 1408 from bf16
     rows, the down product 1408 -> 2048 from fp32 rows, the transposed
     product 1408 -> 2048 from fp32 rows) and the grouped weight
     gradient (64 x 2048 x 1408 from bf16 x fp32 rows, 64 x 1408 x 2048
     from fp32 x fp32 rows, and the first again with its bf16 output),
     each with its count of bf16 wgmma passes and, for a form with an
     fp32 operand, an fp32 `torch._grouped_mm` as its yardstick where
     this build takes one (else bf16); K5 fused NormHead logits at
     Ling-Lite's fp32 head (x bf16, T=8, T=1 and T=40) and rwkv6-3b's
     (T=8, T=64
     in one pass over W, T=65 in two), each also timed on the card with
     the queue held, by its host dispatch alone, and against one fp32
     cuBLAS product on a head normalized beforehand (`product_ms`); K6
     the WKV6 recurrence at rwkv6-3b's prefill (B=8, T=512, 40 heads of
     64, bf16 r/k/v, non-zero state), at decode (T=1, state updated in
     place), at T=100 in fp32 and at T=128 with decays near 0 and near 1,
     each also timed on the card with the queue held and by its host
     dispatch alone; rwkv6's decay kernel at the prefill's 8 x 512 rows,
     a tick's 8 rows and 64 fp32 rows (d = n = 2560), timed the same
     way, and each row's result held bit for bit against the kernel on
     that row alone (fp32 operations at 67 TFLOP/s in its bound);
  4. gradients: one full-width MoE layer at T=256, `FusedFFN`'s grads of
     x, w1, w2, w3 and the gates on the kernels against autograd through
     a plain fp32 composition, before and after the cast to bf16;
  5. serving: full-width Ling-Lite (28 layers, bf16 weights from
     torch.Generator(device="cuda").manual_seed(0)) behind an
     OnlineEngine (8 slots, page 16, prefill chunk 64, context 512),
     16 Poisson requests with prompts of 64-256 tokens and 32 new tokens
     each; K1, K3 and K4 must have launched once per layer and K5 once
     per prefill chunk and per decode tick;
  6. end to end: one request teacher-forced (a 64-token prefill chunk +
     8 decode steps) through the kernels and through the plain modes
     (moe_dispatch="ragged", paged_attn="gathered"), logits compared, K5
     launched once per chunk and per step;
  6b. sampling and speculative decoding on phase 5's model and prompts
     (engines fed all 16 requests at once): requests 0-7 greedy and 8-15
     at temperature 0.8, top-p 0.95, top-k 64 (the greedy streams must be
     phase 5's), again with the radix cache off and with a pool of 96
     pages that preempts (all 16 streams unchanged); speculative decoding
     at k=4 with a 4-layer self-draft (greedy streams phase 5's; K1, K3,
     K4 launched (k+1)*4 + 28 and K5 (k+1) + 1 times per spec tick, and
     28 + 4 and 2 per prefill chunk), with a 28-layer self-draft (every
     draft accepted), and sampled at 0.8; each run's tokens/s, TTFT and
     ITL p50/p99, ticks per token and acceptance, and one sampling call
     at 8 and 40 rows of the vocabulary (CUDA events);
  7. rwkv6 serving: Ling-Lite freed, full-width rwkv6-3b (32 layers, bf16
     weights from torch.Generator(device="cuda").manual_seed(0)):
     `make_prefill` on 8 prompts of 512 tokens (numpy seed 0), then 32
     greedy `decode_step` ticks (K6 and the decay kernel 32 launches and
     K5 one per prefill and per tick); a 64-token prefill of one prompt against 64
     token-by-token ticks (same greedy token, logits within 2^-5 of the
     largest); the same with fp32 activations, and again through the
     plain K5 and K6 (the same greedy token in all four runs; prefill vs
     ticks and kernels vs plain within RWKV_FP32_TOL of the largest
     logit); the offline Flood engine through `launch.serve`'s
     `build_model_engine` (16 requests, 32 new tokens, micro-batch 8) on
     its sampled step at temperature 0 (the same tokens as the engine on
     the greedy step) and at temperature 0.8, seed 0.
     A miss of the prefill-vs-ticks checks is printed at once and fails
     the run after phase 8 and the kernels line, so that those still
     report;
  8. training: the serving models freed, Ling-Lite at full width cut to 4
     layers, fp32 masters from torch.Generator(device="cuda")
     .manual_seed(0), 4 optimizer steps of the port's Trainer (seq 1024,
     microbatch 2, accum 2, remat, fused MoE, spike guard, WSD schedule,
     router warmup active) with every step's dispatch under
     torch.cuda.set_sync_debug_mode("error"); finite losses, a reported
     commit, the launch counts per step (K1 2*L*accum, K2 6*L*accum,
     the weight gradient 3*L*accum) and peak memory under 80 GB;
  8b. checkpoint and exact resume: Ling-Lite at full width cut to 1
     layer (1.09 B parameters; a 13.09 GB checkpoint of fp32 params and
     moments), the batch-size warmup (microbatch 2, 2 -> 8 sequences
     over 4 steps: accum 1, 1, 2, 2, 4, 4) and the router warmup active
     (threefry noise every step), debug guards on; run A trains 6 steps
     checkpointing at 3 and 6 into a temporary directory (removed after;
     the phase fails, naming the bytes, if the disk lacks them) and is
     freed; a fresh Trainer B restores "latest" (step_6, equal to A's
     final state bit for bit), then step_3 (the accum stage carried) and
     trains to 6: its losses, grad norms, params, moments and guard state
     must be A's bit for bit, and the launches per step phase 8's
     formula at each step's accum.  If B parts from A, two uninterrupted
     runs are compared to tell the step from the resume.  Prints the
     saves' fetch and write seconds and GB/s, the restores' seconds and
     GB/s, the warmup noise's ms per step and the step times;
  9. the `kernels` JSON line, the card line, and the result line.
"""
from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
import types
from pathlib import Path

HBM_BYTES_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
SERVE_KERNELS = ("fused_moe_ffn", "paged_attn_scores_max",
                 "paged_attn_accumulate")      # once per layer and step
# phase 3's paged-attention cases (`paged_case`'s arguments), also timed
# by scripts/profile_torch_kernels.py: Ling-Lite's KV heads, 32 logical
# pages of 16 per slot
PA_CASES = {
    "decode": dict(B=8, Q=1, ctx=[100, 300, 0, 171, 256, 0, 129, 233],
                   base=None, n_pages=8 * 32 + 1),
    "verify": dict(B=8, Q=5, ctx=[100, 300, 0, 171, 256, 0, 129, 233],
                   base=None, n_pages=8 * 32 + 1),
    "prefill": dict(B=1, Q=64, ctx=[192], base=128, n_pages=8 * 32 + 1)}


# phase 7's bounds with fp32 activations, shares of the largest logit
# (about ten times the largest reading; PERF.md, Findings)
RWKV_FP32_TOL = {"prefill vs ticks": 7.5e-4, "kernels vs plain": 4.5e-4}

# phase 3's K5 cases (the head's architecture, rows of x) and K6 cases
# (batch, T, r/k/v dtype, decays near 0 and 1), also timed by
# scripts/profile_torch_kernels.py
K5_CASES = {"ling head T=8": ("ling-lite", 8),
            "ling head T=1": ("ling-lite", 1),
            "ling head T=40": ("ling-lite", 40),
            "rwkv6 head T=8": ("rwkv6-3b", 8),
            "rwkv6 head T=64": ("rwkv6-3b", 64),
            "rwkv6 head T=65": ("rwkv6-3b", 65)}
K6_CASES = {"prefill": (8, 512, "bfloat16", False),
            "decode": (8, 1, "bfloat16", False),
            "T=100": (8, 100, "float32", False),
            "decays near 0 and 1": (8, 128, "bfloat16", True)}
# phase 3's cases of rwkv6's decay kernel (rows, their dtype) at
# rwkv6-3b's width: the prefill's 8 x 512 rows, a tick's 8, fp32 rows
DECAY_CASES = {"prefill": (8 * 512, "bfloat16"), "decode": (8, "bfloat16"),
               "fp32 rows": (64, "float32")}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median over `iters` calls of CUDA-event time around one call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median over `iters` calls of CUDA-event time around one call
    enqueued behind a sleep kernel: the host's dispatch of the call
    overlaps the sleep, so only the card's time for the call's work
    remains (cuda_ms also counts the dispatch while the card waits)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)         # ~2.5 ms: longer than dispatch
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def host_ms(fn, iters: int = 50, repeats: int = 5) -> float:
    """Host time of one call of fn (its dispatch alone): the median over
    `repeats` of the mean over `iters` calls that do not wait for the
    card."""
    import torch
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append(1e3 * (time.perf_counter() - t0) / iters)
    torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def bound(nbytes: float, flops: float, flops_s: float = BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flops_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bf16_ulp(t):
    """One bf16 ulp at each element of t (2^(e-8) for |t| in
    [2^(e-1), 2^e))."""
    import torch
    return torch.ldexp(torch.ones_like(t), torch.frexp(t).exponent - 8)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def report(name, shape, err, tol, scale, ms, plain_ms, b_ms, b_by,
           library_ms=None):
    lib = "none" if library_ms is None else f"{library_ms:.4f}ms"
    print(f"[kernels] {name} {shape}: max_abs_err={err:.3e} "
          f"max_rel_err={err / max(scale, 1e-30):.3e} (tolerance "
          f"{tol:.3e}) kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
          f"library={lib} bound={b_ms * 1e3:.2f}us ({b_by}-bound, share "
          f"{b_ms / ms:.1%})")


# ---------------------------------------------------------------------------
# phase 3: per-kernel checks
# ---------------------------------------------------------------------------


def moe_case(cfg, T: int, gen):
    """One MoE layer's bf16 weights (fp32 router) and the routing of T
    random bf16 tokens by its random router: (params, x, tok, gates,
    group_sizes)."""
    import torch
    from repro_torch.core import moe, router
    from repro_torch.models import layers as L
    p = moe.init_moe(cfg, L.Init(device=torch.device("cuda"),
                                 generator=gen))
    x = torch.randn((T, cfg.d_model), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    top_w, top_i = router.route(cfg, p["router"], x)
    tok, gates, group_sizes, _ = moe.sort_slots(cfg, top_w, top_i)
    return p, x, tok, gates, group_sizes


def library_time(candidates):
    """Time the first of `candidates` ((label, fn) pairs: one PyTorch call
    each, a yardstick the port never calls) that runs here; (None,
    reason) when none does."""
    import torch
    reasons = []
    for label, fn in candidates:
        try:
            fn()
            torch.cuda.synchronize()
        except (RuntimeError, TypeError, AttributeError, ValueError,
                NotImplementedError) as e:
            reasons.append(f"{label}: {str(e).splitlines()[0][:120]}")
            continue
        return cuda_ms(fn), label
    return None, "; ".join(reasons)


def kernel_split(fn, prefixes, iters: int = 20):
    """Device time per call of each group of kernels whose names contain
    a prefix, summed by torch.profiler over `iters` calls of fn; None
    where the profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {p: 0.0 for p in prefixes}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        for p in prefixes:
            if p in ev.key:
                out[p] += us / 1e3 / iters
    return out if any(out.values()) else None


def check_k1(cfg, T: int, gen):
    """K1 at Ling-Lite widths with a random router's routing.  Times the
    wrapper (checks, allocation and host dispatch included) and the C
    entry alone on prepared arguments (its kernels' time, also split by
    kernel with the profiler: up, down, and the combine with its index
    passes)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import ops
    m = cfg.moe
    p, x, tok, gates, group_sizes = moe_case(cfg, T, gen)
    cap = tok.shape[0]
    bm = min(128, max(8, cap))
    row_idx, g, tile_group = ops._fused_layout(tok, gates, group_sizes, T,
                                               bm)
    args = (x, p["we1"], p["we2"], p["we3"], row_idx, g, tile_group)
    path = gm.k1_path(row_idx.shape[0], bm, m.n_experts)
    out = gm.fused_moe_ffn(*args)
    ref = gm.fused_moe_ffn_ref(*args)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    # fp32 products of bf16 operands, fp32 hidden (cut exactly into three
    # bf16 pieces for the down product): the two differ only in fp32
    # summation order over d=2048 and ff=1408
    tol = 1e-4 * ref.abs().max().item()
    n_experts = int((group_sizes > 0).sum())
    w_bytes = n_experts * 3 * cfg.d_model * m.expert_d_ff * 2
    b_ms, b_by = bound(w_bytes + nbytes(x, row_idx, g, tile_group)
                       + T * cfg.d_model * 4,
                       2 * cap * 3 * cfg.d_model * m.expert_d_ff)
    ms = cuda_ms(lambda: gm.fused_moe_ffn(*args))
    plain_ms = cuda_ms(lambda: gm.fused_moe_ffn_ref(*args))
    # the C entry alone, its checks and scratch allocation done once
    out_c, c_args, _held = gm._k1_launch(*args, act="swiglu")
    entry = build.entry("fused_moe_ffn")
    build.check(entry(*c_args), "fused_moe_ffn")
    torch.cuda.synchronize()
    if not torch.equal(out_c, out):
        fail(f"fused_moe_ffn T={T}: two launches on the same inputs differ")
    entry_ms = cuda_ms(lambda: entry(*c_args))
    split = kernel_split(lambda: entry(*c_args),
                         ("moe_up", "moe_down", "moe_combine"))
    shape = (f"T={T} cap={cap} bm={bm} tiles={tile_group.numel()} "
             f"experts_routed={n_experts} path={path}")
    report("fused_moe_ffn", shape, err, tol, ref.abs().max().item(), ms,
           plain_ms, b_ms, b_by)
    parts = ("not measured" if split is None else
             " ".join(f"{k}={v:.4f}ms" for k, v in split.items()))
    print(f"[kernels] fused_moe_ffn T={T} path={path}: wrapper={ms:.4f}ms "
          f"kernels alone={entry_ms:.4f}ms (share of bound "
          f"{b_ms / entry_ms:.1%}; wrapper {b_ms / ms:.1%}); profiler "
          f"per call: {parts}")
    if not err <= tol:
        fail(f"fused_moe_ffn T={T}: max_abs_err {err} > tolerance {tol}")
    return dict(max_abs_err=err, tolerance=tol, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=shape,
                path=path, wrapper_ms=ms, device_ms=entry_ms,
                device_split_ms=split)


def paged_case(cfg, *, B, Q, ctx, base, n_pages, gen):
    """Random pools, page tables and queries for one paged-attention
    check.  ctx[b] = tokens the slot holds after this step (0 = inactive:
    its table row stays on the scratch page and every row is masked)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.kernels import ops
    dev = "cuda"
    ps, KV, hd, H = 16, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    n_lp = 512 // ps
    pool = lambda: torch.randn((n_pages, ps, KV, hd), generator=gen,
                               device=dev).to(torch.bfloat16)
    k_pool, v_pool = pool(), pool()
    table = torch.zeros((B, n_lp), dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    used = 0
    for b, c in enumerate(ctx):
        n = -(-c // ps)
        table[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    pos = torch.tensor([[max(c - Q, 0) + j for j in range(Q)] for c in ctx],
                       device=dev)
    if base is not None:
        pos = base + torch.arange(Q, device=dev)[None]
    mask = L.paged_valid_mask(table, pos, page_size=ps)
    q = torch.randn((B, Q, H, hd), generator=gen, device=dev) \
        .to(torch.bfloat16)
    gq = ops._pa_group_q(q, KV)
    mask4 = mask.reshape(B, Q, n_lp, ps)
    return gq, k_pool, v_pool, table, mask4


def pa_bounds(gq, k_pool, table, mask4, pass2: bool):
    """Bytes and flops the data needs: each (slot, kv head) reads the pages
    that hold a valid position; 2*hd flops per valid score (and 2*hd more
    per valid PV term in pass 2)."""
    B, KV, GQ, hd = gq.shape
    Q = mask4.shape[1]
    g = GQ // Q
    ps = k_pool.shape[1]
    live_pages = int(mask4.any(dim=1).any(dim=-1).sum())
    page_bytes = live_pages * ps * KV * hd * 2 * (2 if pass2 else 1)
    valid = int(mask4.sum())
    flops = (4 if pass2 else 2) * hd * valid * g * KV
    out_bytes = B * KV * GQ * 4 * ((hd + 2) if pass2 else 1)
    return bound(page_bytes + nbytes(gq, table, mask4) + out_bytes, flops)


def check_pa(cfg, label, case):
    import torch
    from repro_torch.kernels import paged_attn as pa
    gq, k_pool, v_pool, table, mask4 = case
    m = pa.paged_attn_scores_max(gq, k_pool, table, mask4)
    m_ref = pa.paged_attn_scores_max_ref(gq, k_pool, table, mask4)
    torch.cuda.synchronize()
    inf_k, inf_r = torch.isinf(m), torch.isinf(m_ref)
    if not torch.equal(inf_k, inf_r):
        fail(f"paged_attn_scores_max {label}: -inf rows differ")
    fin = ~inf_r
    err3 = (m[fin] - m_ref[fin]).abs().max().item() if fin.any() else 0.0
    # fp32 dots of bf16 operands in another summation order
    tol3 = 1e-5 * max(m_ref[fin].abs().max().item(), 1.0)
    m_safe = torch.where(fin, m_ref, 0.0)
    num, den = pa.paged_attn_accumulate(gq, k_pool, v_pool, table, mask4,
                                        m_safe)
    num_r, den_r = pa.paged_attn_accumulate_ref(gq, k_pool, v_pool, table,
                                                mask4, m_safe)
    torch.cuda.synchronize()
    if not (torch.equal(num[inf_r], torch.zeros_like(num[inf_r]))
            and torch.equal(den[inf_r], torch.zeros_like(den[inf_r]))):
        fail(f"paged_attn_accumulate {label}: all-masked rows not 0")
    err4 = max((num - num_r).abs().max().item(),
               (den - den_r).abs().max().item())
    # fp32 summation order (1e-5 relative), plus for num one bf16 rounding
    # flip: p is rounded to bf16 before the PV product, and a score that
    # differs in its last fp32 bit can round one p (<= 1) one ulp (2^-8)
    # the other way, moving num by at most 2^-8 * max|v|
    tol4 = (1e-5 * max(num_r.abs().max().item(), den_r.abs().max().item())
            + 2.0 ** -8 * v_pool.float().abs().max().item())
    # ms and plain_ms from an idle queue, as every row; each kernel is one
    # launch shorter than the wrapper's host dispatch, so the card's time
    # for the call (queue held: device_ms) and the dispatch alone
    # (host_ms) stand beside them
    k3 = lambda: pa.paged_attn_scores_max(gq, k_pool, table, mask4)
    k4 = lambda: pa.paged_attn_accumulate(gq, k_pool, v_pool, table, mask4,
                                          m_safe)
    p3 = lambda: pa.paged_attn_scores_max_ref(gq, k_pool, table, mask4)
    p4 = lambda: pa.paged_attn_accumulate_ref(gq, k_pool, v_pool, table,
                                              mask4, m_safe)
    ms3, ms4, pl3, pl4 = cuda_ms(k3), cuda_ms(k4), cuda_ms(p3), cuda_ms(p4)
    dv3, dv4, pd3, pd4 = (device_ms(k3), device_ms(k4), device_ms(p3),
                          device_ms(p4))
    hs3, hs4 = host_ms(k3), host_ms(k4)
    b3, by3 = pa_bounds(gq, k_pool, table, mask4, pass2=False)
    b4, by4 = pa_bounds(gq, k_pool, table, mask4, pass2=True)
    shape = f"{label} q={tuple(gq.shape)} table={tuple(table.shape)}"
    report("paged_attn_scores_max", shape, err3, tol3,
           m_ref[fin].abs().max().item(), ms3, pl3, b3, by3)
    report("paged_attn_accumulate", shape, err4, tol4,
           num_r.abs().max().item(), ms4, pl4, b4, by4)
    print(f"[kernels] paged_attn {label}: the card's time (queue held) "
          f"scores_max={dv3:.4f}ms accumulate={dv4:.4f}ms (plain "
          f"{pd3:.4f} / {pd4:.4f}ms); host dispatch {hs3:.4f} / "
          f"{hs4:.4f}ms")
    if not err3 <= tol3:
        fail(f"paged_attn_scores_max {label}: {err3} > {tol3}")
    if not err4 <= tol4:
        fail(f"paged_attn_accumulate {label}: {err4} > {tol4}")
    row = lambda e, t, ms, pl, b, by, dv, pd, hs: dict(
        max_abs_err=e, tolerance=t, ms=ms, plain_ms=pl, bound_ms=b,
        bound_by=by, library_ms=None, shape=shape, device_ms=dv,
        plain_device_ms=pd, host_ms=hs)
    return (row(err3, tol3, ms3, pl3, b3, by3, dv3, pd3, hs3),
            row(err4, tol4, ms4, pl4, b4, by4, dv4, pd4, hs4))


def _passes(a_dtype, b_dtype) -> int:
    """bf16 wgmma passes per product: an fp32 operand is cut into three
    bf16 pieces; fp32 x fp32 keeps the six piece products with i + j <=
    2."""
    import torch
    return (1, 3, 6)[(a_dtype == torch.float32) + (b_dtype == torch.float32)]


def _fp32_first(fp32_operand, candidates):
    """The library yardsticks in order: for a form with an fp32 operand
    the fp32 call first (if this build of `torch._grouped_mm` takes
    fp32), then bf16; for an all-bf16 form the bf16 calls only."""
    import torch
    if fp32_operand.dtype == torch.float32:
        return candidates
    return [c for c in candidates if "fp32" not in c[0]]


def check_k2(cfg, gen):
    """K2 at the MoE backward's shapes (T=2048 tokens routed by a random
    router: 12288 rows over 64 experts, bm=128) and the grouped weight
    gradient, each in every operand form the backward launches, against
    their plain versions."""
    import torch
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import ops
    p, x, tok, gates, gs = moe_case(cfg, 2048, gen)
    cap, G, bm = tok.shape[0], gs.shape[0], 128
    d, ff = cfg.d_model, cfg.moe.expert_d_ff
    lay = ops.align_layout(gs, cap, bm)
    xs = x[tok]                                   # (cap, d) bf16 rows
    h = torch.randn((cap, ff), generator=gen, device="cuda")    # fp32
    da = torch.randn((cap, ff), generator=gen, device="cuda")   # fp32
    d_out = torch.randn((cap, d), generator=gen, device="cuda")  # fp32
    offs = torch.cumsum(gs, 0).to(torch.int32)
    n_live = int((lay.tile_group < G).sum())
    n_routed = int((gs > 0).sum())
    rows = {}
    # xs W1 (bf16 rows), h W2 (fp32 rows), da1 W1^T (fp32 rows, trans_b)
    for label, lhs, w, trans in (("up d->ff", xs, p["we1"], False),
                                 ("down ff->d", h, p["we2"], False),
                                 ("down^T ff->d", da, p["we1"], True)):
        lhs_pad = ops._take_rows(lhs, lay.row_map)
        K = lhs.shape[1]
        N = w.shape[1] if trans else w.shape[2]
        run = lambda: gm.grouped_matmul_aligned(
            lhs_pad, w, lay.tile_group, bm=bm, trans_b=trans)
        plain = lambda: gm.grouped_matmul_aligned_ref(
            lhs_pad, w, lay.tile_group, bm=bm, trans_b=trans)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        # fp32 products of operands exact in fp32 (bf16 upcast): the two
        # differ only in fp32 summation order over K
        tol = 1e-4 * ref.abs().max().item()
        b_ms, b_by = bound(n_live * bm * K * lhs.element_size()
                           + n_routed * K * N * 2 + out.numel() * 4
                           + nbytes(lay.tile_group), 2 * cap * K * N)
        ms, plain_ms = cuda_ms(run), cuda_ms(plain, iters=5, warmup=1)
        a16 = lhs.to(torch.bfloat16)
        b16 = w.transpose(1, 2) if trans else w
        b16_cm = w if trans else w.transpose(1, 2).contiguous() \
            .transpose(1, 2)
        b32 = b16.float() if lhs.dtype == torch.float32 else None
        lib_ms, lib = library_time(_fp32_first(lhs, [
            ("torch._grouped_mm fp32", lambda: torch._grouped_mm(
                lhs, b32, offs=offs)),
            ("torch._grouped_mm bf16", lambda: torch._grouped_mm(
                a16, b16, offs=offs)),
            ("torch._grouped_mm bf16, column-major rhs",
             lambda: torch._grouped_mm(a16, b16_cm, offs=offs))]))
        shape = (f"{label} M={cap} M_pad={lhs_pad.shape[0]} K={K} N={N} "
                 f"G={G} live_tiles={n_live} lhs={lhs.dtype} "
                 f"trans_b={trans} wgmma_passes="
                 f"{_passes(lhs.dtype, torch.bfloat16)} library=({lib})")
        report("grouped_matmul_aligned", shape, err, tol,
               ref.abs().max().item(), ms, plain_ms, b_ms, b_by, lib_ms)
        if not err <= tol:
            fail(f"grouped_matmul_aligned {label}: {err} > {tol}")
        rows[label] = dict(max_abs_err=err, tolerance=tol, ms=ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=lib_ms, shape=shape)
        del lhs_pad, out, ref, a16, b16, b16_cm, b32

    wrows = {}
    # dW1 = xs^T da1 (bf16 x fp32), dW2 = h^T d_out (fp32 x fp32); dW1
    # again as the training step runs it, rounded to bf16 in the epilogue
    for label, lhs, rhs, odt in (
            ("train", xs, da, torch.float32),
            ("train fp32 x fp32", h, d_out, torch.float32),
            ("train bf16 output", xs, da, torch.bfloat16)):
        run = lambda: gm.grouped_matmul_wgrad(lhs, rhs, gs, out_dtype=odt)
        plain = lambda: gm.grouped_matmul_wgrad_ref(lhs, rhs, gs,
                                                    out_dtype=odt)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        # fp32 order over rows: 1e-4 of the largest value; a bf16 output
        # is each fp32 sum rounded once, so a sum near a rounding boundary
        # may round one ulp the other way: one ulp of each element on top
        ref32 = ref.float()
        err = ((out.float() - ref32).abs()
               - (bf16_ulp(ref32) if odt == torch.bfloat16 else 0.0)) \
            .max().item()
        tol = 1e-4 * ref32.abs().max().item()
        K, N = lhs.shape[1], rhs.shape[1]
        b_ms, b_by = bound(nbytes(lhs, rhs, gs, out), 2 * cap * K * N)
        ms, plain_ms = cuda_ms(run), cuda_ms(plain, iters=5, warmup=1)
        lt16, r16 = lhs.t().to(torch.bfloat16), rhs.to(torch.bfloat16)
        lt16_rm = lt16.contiguous()
        lt32, r32 = lhs.t().float(), rhs.float()
        cand = [("torch._grouped_mm fp32", lambda: torch._grouped_mm(
                    lt32, r32, offs=offs)),
                ("torch._grouped_mm bf16", lambda: torch._grouped_mm(
                    lt16, r16, offs=offs)),
                ("torch._grouped_mm bf16, row-major lhs^T",
                 lambda: torch._grouped_mm(lt16_rm, r16, offs=offs))]
        lib_ms, lib = library_time(_fp32_first(
            lhs if lhs.dtype == torch.float32 else rhs, cand))
        beyond = " (error beyond one ulp)" if odt == torch.bfloat16 else ""
        shape = (f"{label} M={cap} G={G} K={K} N={N} lhs={lhs.dtype} "
                 f"rhs={rhs.dtype} out={odt}{beyond} wgmma_passes="
                 f"{_passes(lhs.dtype, rhs.dtype)} library=({lib})")
        report("grouped_matmul_wgrad", shape, err, tol,
               ref.abs().max().item(), ms, plain_ms, b_ms, b_by, lib_ms)
        if not err <= tol:
            fail(f"grouped_matmul_wgrad {label}: {err} > {tol}")
        wrows[label] = dict(max_abs_err=err, tolerance=tol, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=lib_ms, shape=shape)
        del out, ref, ref32, lt16, r16, lt16_rm, lt32, r32
    return rows, wrows


def k5_case(arch: str, T: int, gen):
    """A random fp32 head (V, d) of `arch`'s widths and bf16 x (T, d)."""
    import torch
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    w = 0.02 * torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                           device="cuda")
    x = torch.randn((T, cfg.d_model), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    return x, w


def check_k5(label, x, w):
    """K5 on x (T, d) bf16 and an fp32 head w (V, d) against its plain
    version (normalize the rows in fp32, then one fp32 product).  Beside
    `ms` (the wrapper from an idle queue): the card's time for the call
    (queue held), the host dispatch alone, and `product_ms`, one fp32
    cuBLAS product x W_n^T on a head normalized beforehand (the same
    bytes read once: a yardstick, not the same function)."""
    import torch
    from repro_torch.core.normhead import normalize_rows
    from repro_torch.kernels import normhead as nh
    (T, d), V = x.shape, w.shape[0]
    out, ref = nh.normhead_matmul(x, w), nh.normhead_matmul_ref(x, w)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    # fp32 sums in another order, and the division after the product
    # where the plain version divides W first: fp32 rounding only
    tol = 1e-4 * ref.abs().max().item()
    b_ms, b_by = bound(nbytes(x, w, out), 2 * T * V * d + 2 * V * d)
    run = lambda: nh.normhead_matmul(x, w)
    plain = lambda: nh.normhead_matmul_ref(x, w)
    ms, plain_ms = cuda_ms(run), cuda_ms(plain)
    dv, pdv, hs = device_ms(run), device_ms(plain), host_ms(run)
    wn, xf = normalize_rows(w, nh.EPS), x.float()
    product_ms = cuda_ms(lambda: torch.matmul(xf, wn.T))
    del wn, xf
    shape = f"{label} x=({T}, {d}) bf16 W=({V}, {d}) fp32"
    report("normhead_matmul", shape, err, tol, ref.abs().max().item(), ms,
           plain_ms, b_ms, b_by)
    print(f"[kernels] normhead_matmul {label}: the card's time (queue "
          f"held) {dv:.4f}ms (plain {pdv:.4f}ms); host dispatch {hs:.4f}ms; "
          f"fp32 product on a normalized head {product_ms:.4f}ms")
    if not err <= tol:
        fail(f"normhead_matmul {label} T={T}: {err} > {tol}")
    return dict(max_abs_err=err, tolerance=tol, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=shape,
                device_ms=dv, plain_device_ms=pdv, host_ms=hs,
                product_ms=product_ms)


def k6_case(B: int, T: int, dtype: str, extreme: bool, gen):
    """K6's operands at rwkv6-3b's heads (40 of 64) from a non-zero state:
    r, k, v ~ N(0, 1) in `dtype`, w = exp(-exp(.)) in (0, 1) (`extreme`:
    exp(-exp(N(0, 1) +- 3)), each decay near 0 or near 1), u ~ 0.5 N(0,
    1), s0 ~ 0.1 N(0, 1)."""
    import torch
    from repro_torch.configs.base import get_config
    cfg = get_config("rwkv6-3b")
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    rnd = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    r, k, v = (rnd(B, T, H, hd).to(getattr(torch, dtype)) for _ in range(3))
    if extreme:
        shift = 3.0 * torch.where(rnd(B, T, H, hd) > 0, 1.0, -1.0)
        w = torch.exp(-torch.exp(rnd(B, T, H, hd) + shift))
    else:
        w = torch.exp(-torch.exp(rnd(B, T, H, hd) - 1.0))
    return r, k, v, w, 0.5 * rnd(H, hd), 0.1 * rnd(B, H, hd, hd)


def check_k6(label, r, k, v, w, u, s0):
    """K6 against its plain version (the sequential recurrence in fp32);
    the state is written in place.  Beside `ms`: the card's time for the
    call (queue held) and the host dispatch alone."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    (B, T, H, hd), dtype = r.shape, r.dtype
    state = s0.clone()
    y, sT = wk.wkv6(r, k, v, w, u, state, out_state=state)
    y_ref, s_ref = wk.wkv6_ref(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    if sT.data_ptr() != state.data_ptr():
        fail(f"wkv6 {label}: the state was not written in place")
    err_s = (sT - s_ref).abs().max().item()
    err_y = ((y.float() - y_ref.float()).abs()
             - (bf16_ulp(y_ref.float()) if dtype == torch.bfloat16
                else 0.0)).max().item()
    # fp32 sums in another order: 1e-4 of the largest output; a bf16 y is
    # the fp32 sum rounded once, as the reference's y.astype(cdt), so one
    # ulp of each element (a sum near a rounding boundary can round the
    # other way) is allowed on top
    tol_s = 1e-4 * s_ref.abs().max().item()
    tol_y = 1e-4 * y_ref.float().abs().max().item()
    st = s0.clone()
    run = lambda: wk.wkv6(r, k, v, w, u, st, out_state=st)
    plain = lambda: wk.wkv6_ref(r, k, v, w, u, s0)
    ms = cuda_ms(run)
    plain_ms = cuda_ms(plain, iters=5, warmup=1)
    dv, hs = device_ms(run), host_ms(run)
    pdv = device_ms(plain, iters=5, warmup=1)
    b_ms, b_by = bound(nbytes(r, k, v, w, u, s0, y) + sT.numel() * 4,
                       5 * hd * hd * B * H * T)
    shape = (f"{label} B={B} T={T} H={H} hd={hd} r/k/v={dtype} "
             f"(y max_abs_err beyond one ulp {err_y:.3e}, tolerance "
             f"{tol_y:.3e}; state {err_s:.3e}, tolerance {tol_s:.3e})")
    report("wkv6", shape, max(err_s, err_y), max(tol_s, tol_y),
           s_ref.abs().max().item(), ms, plain_ms, b_ms, b_by)
    print(f"[kernels] wkv6 {label}: the card's time (queue held) "
          f"{dv:.4f}ms (plain {pdv:.4f}ms); host dispatch {hs:.4f}ms")
    if not (err_s <= tol_s and err_y <= tol_y):
        fail(f"wkv6 {label}: state {err_s} > {tol_s} or y {err_y} > {tol_y}")
    return dict(max_abs_err=max(err_s, err_y), tolerance=max(tol_s, tol_y),
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, shape=shape, device_ms=dv,
                plain_device_ms=pdv, host_ms=hs)


def decay_case(M: int, dtype: str, gen):
    """The decay kernel's operands at rwkv6-3b's width: rows ~ N(0, 1) in
    `dtype`, A ~ N(0, 1 / d), B ~ N(0, 1 / 8), w0 ~ N(0, 1) - 1, so that
    w spreads over (0, 1) and moves with every term of the sums."""
    import torch
    from repro_torch.configs.base import get_config
    d = get_config("rwkv6-3b").d_model
    rnd = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    return (rnd(M, d).to(getattr(torch, dtype)), rnd(d, 32) / d ** 0.5,
            rnd(32, d) / 8 ** 0.5, rnd(d) - 1.0)


def check_decay(label, x, a, b, w0):
    """rwkv6's decay kernel against its plain version (the reference's
    two fp32 products), and each of up to 64 rows against the kernel on
    that row alone, bit for bit.  Beside `ms`: the card's time for the
    call (queue held) and the host dispatch alone."""
    import torch
    from repro_torch.kernels import rwkv_decay as dk
    M, d = x.shape
    n = b.shape[1]
    w = dk.rwkv_decay(x, a, b, w0)
    ref = dk.rwkv_decay_ref(x, a, b, w0)
    alone = torch.cat([dk.rwkv_decay(x[i:i + 1], a, b, w0)
                       for i in range(min(M, 64))])
    torch.cuda.synchronize()
    err = (w - ref).abs().max().item()
    # fp32 sums in another order: 1e-4 of the largest output
    tol = 1e-4 * ref.abs().max().item()
    run = lambda: dk.rwkv_decay(x, a, b, w0)
    plain = lambda: dk.rwkv_decay_ref(x, a, b, w0)
    ms, plain_ms = cuda_ms(run), cuda_ms(plain)
    dv, hs, pdv = device_ms(run), host_ms(run), device_ms(plain)
    b_ms, b_by = bound(nbytes(x, a, b, w0, w),
                       2 * M * 32 * (d + n), FP32_FLOPS)
    same = torch.equal(alone, w[:alone.shape[0]])
    shape = (f"{label} rows={M} d={d} n={n} x={x.dtype} (each of "
             f"{alone.shape[0]} rows alone gives the same bits: {same})")
    report("rwkv_decay", shape, err, tol, ref.abs().max().item(), ms,
           plain_ms, b_ms, b_by)
    print(f"[kernels] rwkv_decay {label}: the card's time (queue held) "
          f"{dv:.4f}ms (plain {pdv:.4f}ms); host dispatch {hs:.4f}ms")
    if not (err <= tol and same):
        fail(f"rwkv_decay {label}: {err} > {tol}, or a row alone gives "
             f"other bits ({same})")
    return dict(max_abs_err=err, tolerance=tol, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=shape,
                device_ms=dv, plain_device_ms=pdv, host_ms=hs)


# ---------------------------------------------------------------------------
# phase 4: FusedFFN gradients on the kernels
# ---------------------------------------------------------------------------


def check_grads(cfg, gen, T: int = 256):
    """`FusedFFN`'s grads on the kernels against autograd through a plain
    fp32 composition (per-expert fp32 matmuls), before the cast to the
    inputs' dtype (fp32 leaves in the composition) and after it (bf16
    leaves, whose .float() casts round the grads as the reference's
    astype transposes do)."""
    import torch
    from repro_torch.core import moe
    from repro_torch.models import layers as L
    p, x, tok, gates, gs = moe_case(cfg, T, gen)
    d, k = cfg.d_model, cfg.moe.top_k
    g = torch.randn((T, d), generator=gen, device="cuda")
    inputs = (x, p["we1"], p["we2"], p["we3"], gates)
    sizes = gs.tolist()

    def plain(x_, w1, w2, w3, gate):
        xs = x_[tok].float()
        outs, start = [], 0
        for e, n in enumerate(sizes):
            if n:
                r = xs[start:start + n]
                h = L._act("swiglu", r @ w1[e].float()) * (r @ w3[e].float())
                outs.append(h @ w2[e].float())
            start += n
        o = torch.cat(outs) * gate.float()[:, None]
        return torch.zeros((T, d), device="cuda").index_add(0, tok, o)

    def grads(fn, leaves):
        leaves = [t.detach().clone().requires_grad_() for t in leaves]
        fn(*leaves).backward(g)
        return [t.grad for t in leaves]

    kern = grads(lambda *a: moe.FusedFFN.apply("swiglu", a[0], a[1], a[2],
                                               a[3], tok, a[4], gs), inputs)
    dxs, dw1, dw2, dw3, dgate = moe.fused_ffn_backward(
        "swiglu", *inputs[:4], tok, gates, gs, g)
    dx = torch.zeros((T, d), device="cuda").index_add_(0, tok, dxs)
    pre = [dx, dw1, dw2, dw3, dgate]
    ref32 = grads(plain, [t.float() for t in inputs])
    ref16 = grads(plain, inputs)
    torch.cuda.synchronize()
    names = ("x", "w1", "w2", "w3", "gate")
    worst = {}
    for name, a, b, c, r in zip(names, pre, ref32, kern, ref16):
        m32, m16 = b.abs().max().item(), r.float().abs().max().item()
        e32 = (a - b).abs().max().item()
        e16 = ((c.float() - r.float()).abs()
               - bf16_ulp(r.float())).max().item()
        # before the cast: fp32 summation order, 1e-4 of the largest grad.
        # After it: one bf16 ulp of each element on top (an fp32
        # difference near a rounding boundary rounds one ulp the other
        # way); x's grad also sums its k gathered rows in bf16, in
        # another order (atomics against a sorted accumulate), so it gets
        # 2^-8 of its largest value per summand.
        tol16 = 1e-4 * m16 + (k * 2.0 ** -8 * m16 if name == "x" else 0.0)
        print(f"[grads] {name}: fp32 max_abs_err={e32:.3e} (tolerance "
              f"{1e-4 * m32:.3e}); {c.dtype} excess over one ulp="
              f"{e16:.3e} (tolerance {tol16:.3e})")
        if not (c.dtype == inputs[names.index(name)].dtype
                and e32 <= 1e-4 * m32 and e16 <= tol16):
            fail(f"FusedFFN grad of {name}: fp32 err {e32} (max {m32}), "
                 f"{c.dtype} excess {e16} > {tol16}")
        worst[name] = e32
    return worst


# ---------------------------------------------------------------------------
# phases 5-6: serving and the end-to-end check
# ---------------------------------------------------------------------------


def serve(cfg, params):
    import torch
    from repro_torch import api
    from repro_torch.kernels import build
    from repro_torch.serving.online import (OnlineConfig, OnlineEngine,
                                            run_poisson_load)
    runner = api.Runner(cfg, device="cuda")
    eng = OnlineEngine(runner, params, OnlineConfig(
        max_slots=8, max_context=512, page_size=16, prefill_chunk=64))
    run_poisson_load(eng, rate=100.0, n_requests=2, prompt_len=64,
                     max_new=2, vocab_size=cfg.vocab_size, seed=7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    eng.step_calls = {k: 0 for k in eng.step_calls}
    n_req, max_new = 16, 32
    # 1000 req/s: the 16 arrivals land within a few ms, so all 8 slots
    # fill at once and stay busy while the queue drains
    rep = run_poisson_load(eng, rate=1000.0, n_requests=n_req,
                           prompt_len=(64, 256), max_new=max_new,
                           vocab_size=cfg.vocab_size, seed=0)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    calls = eng.step_calls
    steps = calls["prefill"] + calls["decode"]
    per_call = cfg.n_layers * steps
    print(f"[serve] prompts={rep['prompt_len']}")
    print(f"[serve] requests={n_req} tokens_out={rep['tokens_out']} "
          f"prefill_chunks={calls['prefill']} decode_ticks={calls['decode']}"
          f" launches={launches} expected {per_call} of K1/K3/K4 and "
          f"{steps} of normhead_matmul")
    print(f"[serve] tok/s={rep['tok_s']:.1f} ttft p50/p99="
          f"{rep['ttft_p50_ms']:.1f}/{rep['ttft_p99_ms']:.1f}ms itl p50/p99="
          f"{rep['itl_p50_ms']:.2f}/{rep['itl_p99_ms']:.2f}ms "
          f"wall={rep['wall_s']:.2f}s preempts={rep['preemptions']} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f}GiB")
    if rep["tokens_out"] != n_req * max_new:
        fail(f"served {rep['tokens_out']} tokens, expected {n_req * max_new}")
    for name, n in launches.items():
        want = (per_call if name in SERVE_KERNELS else
                steps if name == "normhead_matmul" else 0)
        if n != want:
            fail(f"{name} launched {n} times in serving, expected {want} "
                 f"({cfg.n_layers} layers, {calls})")
    return rep, launches


# ---------------------------------------------------------------------------
# phase 6b: sampling, speculative decoding, preemption replay
# ---------------------------------------------------------------------------


def _burst(runner, params, ocfg, reqs, drafter=None):
    """Serve `reqs` submitted at once through a fresh engine: (streams,
    figures, engine).  Figures on the host clock: output tokens/s, TTFT
    and ITL p50/p99, ticks per emitted token after the first."""
    import numpy as np
    import torch
    from repro_torch.serving.online import OnlineEngine
    eng = OnlineEngine(runner, params, ocfg, drafter=drafter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        r.arrival_t = t0
    eng.submit_many(reqs)
    eng.run(max_ticks=100_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ttft = [1e3 * (r.first_token_t - r.arrival_t) for r in reqs]
    itl = [1e3 * (b - a) for r in reqs
           for a, b in zip(r.token_times, r.token_times[1:])]
    n_tok = sum(len(r.out) for r in reqs)
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else 0.0
    fig = dict(tok_s=n_tok / wall, ttft_p50_ms=pct(ttft, 50),
               ttft_p99_ms=pct(ttft, 99), itl_p50_ms=pct(itl, 50),
               itl_p99_ms=pct(itl, 99), tokens=n_tok, wall_s=wall,
               ticks_per_token=(sum(r.n_decode_ticks for r in reqs)
                                / max(sum(len(r.out) - 1 for r in reqs), 1)),
               acceptance=eng.spec_accepted / max(eng.spec_proposed, 1),
               preemptions=eng.n_preemptions)
    return [list(r.out) for r in reqs], fig, eng


def serve_sampled(cfg, params, base, card):
    """Phase 6b on phase 5's model and prompts: mixed-temperature serving
    (again with the radix cache off and with a pool that preempts),
    greedy speculation with a 4-layer and a 28-layer self-draft, sampled
    speculation, the launches per spec tick, and the sampling call's
    time.  Returns the launches of the greedy spec run."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.kernels import build
    from repro_torch.models import embedding as emb
    from repro_torch.serving.draft import SelfDrafter
    from repro_torch.serving.online import OnlineConfig, OnlineRequest
    runner = api.Runner(cfg, device="cuda")
    prompts = [np.asarray(p, np.int32) for p in base["prompts"]]
    greedy = base["outputs"]
    geo = dict(max_slots=8, max_context=512, page_size=16, prefill_chunk=64)
    hot = dict(temperature=0.8, top_p=0.95, top_k=64)
    K, DL = 4, 4

    def reqs(mixed=True, **knobs):
        return [OnlineRequest(
            rid=i, prompt=p, max_new=32,
            **(dict(hot, seed=1000 + i) if mixed and i >= 8 else knobs))
            for i, p in enumerate(prompts)]

    def show(label, fig):
        print(f"[sample] {label}: tok/s={fig['tok_s']:.2f} ttft p50/p99="
              f"{fig['ttft_p50_ms']:.1f}/{fig['ttft_p99_ms']:.1f}ms itl "
              f"p50/p99={fig['itl_p50_ms']:.2f}/{fig['itl_p99_ms']:.2f}ms "
              f"ticks/token={fig['ticks_per_token']:.3f} acceptance="
              f"{fig['acceptance']:.4f} preemptions={fig['preemptions']} "
              f"tokens={fig['tokens']} wall={fig['wall_s']:.2f}s [{card}]")

    # 1. mixed sampling: requests 0-7 greedy, 8-15 at temperature 0.8
    mixed, fig, _ = _burst(runner, params, OnlineConfig(**geo), reqs())
    show("mixed temperatures (0-7 greedy, 8-15 at 0.8 / 0.95 / 64)", fig)
    if mixed[:8] != greedy[:8]:
        fail("phase 6b: temperature-0 streams differ from phase 5's")
    if fig["tokens"] != 16 * 32:
        fail(f"phase 6b: mixed run emitted {fig['tokens']} tokens")
    off, fig, _ = _burst(runner, params,
                         OnlineConfig(**geo, radix_cache=False), reqs())
    show("mixed, radix cache off", fig)
    cut, fig, eng = _burst(runner, params, OnlineConfig(**geo, n_pages=97),
                           reqs())
    show("mixed, pool cut to 96 pages", fig)
    if eng.n_preemptions < 1:
        fail("phase 6b: the cut pool preempted nothing")
    for label, streams in (("radix off", off), ("preempted", cut)):
        if streams != mixed:
            bad = [i for i in range(16) if streams[i] != mixed[i]]
            fail(f"phase 6b: {label} streams differ from the first run's "
                 f"(requests {bad})")

    # 2. greedy speculation, 4-layer self-draft; 5. its launches
    torch.cuda.synchronize()
    build.reset_launches()
    spec, fig, eng = _burst(runner, params, OnlineConfig(**geo, spec_k=K),
                            reqs(mixed=False), SelfDrafter(DL))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    show(f"greedy spec k={K}, {DL}-layer self-draft", fig)
    if spec != greedy:
        bad = [i for i in range(16) if spec[i] != greedy[i]]
        fail(f"phase 6b: greedy spec streams differ from phase 5's "
             f"(requests {bad})")
    calls = eng.step_calls
    per_tick = {n: (K + 1) * DL + cfg.n_layers for n in SERVE_KERNELS}
    per_tick["normhead_matmul"] = (K + 1) + 1
    per_chunk = {n: cfg.n_layers + DL for n in SERVE_KERNELS}
    per_chunk["normhead_matmul"] = 2            # the target's and drafter's
    print(f"[sample] spec launches {launches} over {calls['prefill']} "
          f"prefill chunks (target + drafter) and {calls['verify']} spec "
          f"ticks; per spec tick expected {per_tick}")
    if calls["decode"] or calls["draft"] != calls["verify"]:
        fail(f"phase 6b: spec engine step calls {calls}")
    for name, n in launches.items():
        want = (per_chunk.get(name, 0) * calls["prefill"]
                + per_tick.get(name, 0) * calls["verify"])
        if n != want:
            fail(f"phase 6b: {name} launched {n} times, expected {want} "
                 f"({per_tick.get(name, 0)} per spec tick)")

    # 3. a full-depth self-draft accepts every draft
    full, fig, eng = _burst(runner, params, OnlineConfig(**geo, spec_k=K),
                            reqs(mixed=False), SelfDrafter(cfg.n_layers))
    show(f"greedy spec k={K}, full-depth self-draft", fig)
    if eng.spec_accepted != eng.spec_proposed or full != greedy:
        fail(f"phase 6b: full-depth self-draft accepted "
             f"{eng.spec_accepted} of {eng.spec_proposed} drafts, streams "
             f"equal phase 5's: {full == greedy}")

    # 4. sampled speculation
    _, fig, _ = _burst(runner, params, OnlineConfig(**geo, spec_k=K),
                       reqs(mixed=False, seed=7, **hot), SelfDrafter(DL))
    show(f"sampled spec k={K} at 0.8 / 0.95 / 64, {DL}-layer self-draft",
         fig)
    if fig["tokens"] != 16 * 32:
        fail(f"phase 6b: sampled spec emitted {fig['tokens']} tokens")

    # one sampling call (transforms, keys, gumbel draw) at a tick's rows
    # and at a k = 4 verify pass's
    g = torch.Generator(device="cuda").manual_seed(6)
    for T in (8, 8 * (K + 1)):
        lg = torch.randn((T, cfg.vocab_size), generator=g, device="cuda")
        knobs = (torch.arange(T, device="cuda"),
                 torch.full((T,), 0.8, device="cuda"),
                 torch.full((T,), 0.95, device="cuda"),
                 torch.full((T,), 64, device="cuda"))
        ms = cuda_ms(lambda: emb.sharded_sample(
            cfg, lg, seeds=knobs[0], pos=knobs[0], temperature=knobs[1],
            top_p=knobs[2], top_k=knobs[3]))
        print(f"[sample] one sampling call at {T} x {cfg.vocab_size}: "
              f"{ms:.4f}ms [{card}]")
    return launches


# ---------------------------------------------------------------------------
# phase 7: rwkv6 serving
# ---------------------------------------------------------------------------


def prefill_and_ticks(cfg, params, tokens):
    """Last-position logits of rwkv6 over `tokens` (1, n): one prefill,
    and n decode ticks from zeroed caches."""
    import torch
    from repro_torch.models import model as M
    with torch.no_grad():
        la, _ = M.prefill_logits(cfg, params, {"tokens": tokens})
        c1 = M.init_caches(cfg, 1, tokens.device)
        for pos in range(tokens.shape[1]):
            lb, c1 = M.decode_logits(cfg, params, c1, tokens[:, pos])
    return la, lb


@contextlib.contextmanager
def plain_k5_k6():
    """Serve through the plain versions of K5 and K6 on CUDA tensors, the
    witness the kernels' logits are held against (no launch counted)."""
    from repro_torch.kernels import normhead as nh
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import wkv6 as wk

    def wkv6_plain(r, k, v, w, u, state, *, out_state=None):
        y, sT = wk.wkv6_ref(r, k, v, w, u, state)
        return y, (sT if out_state is None else out_state.copy_(sT))

    saved = kops.normhead_logits, kops.wkv6
    kops.normhead_logits, kops.wkv6 = nh.normhead_matmul_ref, wkv6_plain
    try:
        yield
    finally:
        kops.normhead_logits, kops.wkv6 = saved


def rwkv_serve(card):
    """Full-width rwkv6-3b: prefill + greedy decode through the Runner,
    the prefill/decode consistency on the card, and the offline Flood
    engine.  Returns the launches of the prefill + ticks run and the
    prefill-vs-ticks checks that failed."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import build_model_engine
    from repro_torch.serving.flood import FloodEngine, GenRequest
    from repro_torch.serving.segment_cache import SegmentCache
    cfg = get_config("rwkv6-3b")
    B, S, ticks = 8, 512, 32
    t0 = time.perf_counter()
    runner = api.Runner(cfg, device="cuda")
    params = runner.init_params(0)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    print(f"[rwkv] rwkv6-3b {cfg.n_layers} layers d={cfg.d_model} heads="
          f"{cfg.d_model // cfg.rwkv_head_dim}x{cfg.rwkv_head_dim} d_ff="
          f"{cfg.d_ff} vocab={cfg.vocab_size}: "
          f"{sum(t.numel() for t in leaves) / 1e9:.3f}B params, "
          f"{nbytes(*leaves) / 2**30:.2f}GiB, init "
          f"{time.perf_counter() - t0:.1f}s (depth not cut)")
    prefill, decode = runner.make_prefill(), runner.make_decode_step()
    prompts = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S))).cuda()
    # warm-up: cuBLAS handles and the allocator at these shapes
    tok, caches = prefill(params, {"tokens": prompts})
    decode(params, caches, tok, S)
    del caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    tok, caches = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    after_prefill = dict(build.LAUNCHES)
    out = [tok]
    for pos in range(S, S + ticks):
        tok, caches = decode(params, caches, tok, pos)
        out.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    toks = torch.stack(out).cpu()
    prefill_ms, tick_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1) / ticks
    print(f"[rwkv] prefill B={B} S={S}: {prefill_ms:.2f}ms "
          f"({B * S / (t1 - t0):.0f} prompt tokens/s); {ticks} decode ticks:"
          f" {tick_ms:.2f}ms per tick ({B * ticks / (t2 - t1):.1f} tokens/s);"
          f" peak max_memory_allocated {peak / 2**30:.2f}GiB; launches "
          f"after the prefill {after_prefill}, after the ticks {launches} "
          f"[{card}]")
    want_prefill = {n: 0 for n in launches}
    want_prefill.update(wkv6=cfg.n_layers, normhead_matmul=1,
                        rwkv_decay=cfg.n_layers)
    want_all = dict(want_prefill, wkv6=cfg.n_layers * (1 + ticks),
                    normhead_matmul=1 + ticks,
                    rwkv_decay=cfg.n_layers * (1 + ticks))
    if after_prefill != want_prefill or launches != want_all:
        fail(f"rwkv6 serving launches {after_prefill} / {launches}, "
             f"expected {want_prefill} / {want_all}")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail("rwkv6 serving: tokens out of the vocabulary")
    del caches

    # consistency on the card: one 64-token prefill vs 64 decode ticks
    n = 64
    p1 = prompts[:1, :n]
    la, lb = prefill_and_ticks(cfg, params, p1)
    err = (la - lb).abs().max().item()
    # bf16 activations: every op of the block gives a row the same bits
    # whatever the rows in the call (the decay on its kernel), so the two
    # agree; 2^-5 of the largest logit
    tol = 2.0 ** -5 * la.abs().max().item()
    same = int(la.argmax(-1).item()) == int(lb.argmax(-1).item())
    print(f"[rwkv] prefill {n} tokens vs {n} decode ticks: logits "
          f"max_abs_err={err:.4e} (tolerance {tol:.4e}) same greedy token="
          f"{same}")
    ok16 = same and err <= tol and bool(torch.isfinite(la).all())
    # the same with fp32 activations, where rounding stays far below a
    # fault: prefill vs ticks, and the kernels' logits (prefill and last
    # tick) against the same runs through the plain K5 and K6, each bound
    # RWKV_FP32_TOL of the largest logit
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    fa, fb = prefill_and_ticks(c32, params, p1)
    with plain_k5_k6():
        pa, pb = prefill_and_ticks(c32, params, p1)
    top = pa.abs().max().item()
    err32 = (fa - fb).abs().max().item()
    errk = max((fa - pa).abs().max().item(), (fb - pb).abs().max().item())
    tol32 = {k: v * top for k, v in RWKV_FP32_TOL.items()}
    same32 = len({int(t.argmax(-1).item()) for t in (fa, fb, pa, pb)}) == 1
    print(f"[rwkv] fp32 activations: prefill vs ticks max_abs_err="
          f"{err32:.4e} ({err32 / top:.3e} of the largest, tolerance "
          f"{tol32['prefill vs ticks']:.4e}); kernels vs plain K5/K6 "
          f"max_abs_err={errk:.4e} ({errk / top:.3e} of the largest, "
          f"tolerance {tol32['kernels vs plain']:.4e}); same greedy token="
          f"{same32}")
    ok32 = (same32 and err32 <= tol32["prefill vs ticks"]
            and errk <= tol32["kernels vs plain"]
            and all(bool(torch.isfinite(t).all()) for t in (fa, fb)))
    failed = []
    if not ok16:
        failed.append(f"rwkv6 prefill vs decode: {err} > {tol} or token "
                      f"differs")
    if not ok32:
        failed.append(f"rwkv6 fp32: prefill vs decode {err32}, kernels vs "
                      f"plain {errk} (tolerances {tol32}) or a token "
                      f"differs")
    for msg in failed:
        print(f"chip_smoke: FAIL (the run fails at its end): {msg}",
              file=sys.stderr)

    # the offline Flood engine, through launch.serve's build_model_engine
    # (its sampled decode step): at temperature 0, against the same
    # engine on the greedy step, and at temperature 0.8
    def flood(fns, label):
        rs = np.random.RandomState(0)
        reqs = [GenRequest(rid=i, prompt=rs.randint(0, cfg.vocab_size, 8)
                           .astype(np.int32), max_new=32) for i in range(16)]
        embed_fn, stage_fns, head_fn = fns
        eng = FloodEngine(stage_fns, head_fn, embed_fn,
                          cache=SegmentCache(max_tokens=1 << 16,
                                             initial_segment=32,
                                             extend_chunk=32), microbatch=8)
        eng.submit(reqs)
        stats = eng.run()
        torch.cuda.synchronize()
        print(f"[rwkv] Flood engine {label}: 16 requests x 32 new tokens, "
              f"micro-batch 8, 2 stages: tokens={stats.tokens_out} wall="
              f"{stats.wall_s:.2f}s tok/s={stats.tokens_per_s:.1f} "
              f"ticks={stats.ticks} [{card}]")
        if stats.tokens_out != 16 * 32 or not all(len(r.out) == 32
                                                  for r in reqs):
            fail(f"Flood engine {label} emitted {stats.tokens_out} tokens, "
                 f"expected {16 * 32}")
        return [r.out for r in reqs]

    cold = flood(build_model_engine(runner, params, 2, 8), "temperature 0")
    greedy_step = runner.make_decode_step()
    greedy_runner = types.SimpleNamespace(
        device=runner.device, init_caches=runner.init_caches,
        make_decode_step=lambda sample: (
            lambda p, c, t, pos, *knobs: greedy_step(p, c, t, pos)))
    if flood(build_model_engine(greedy_runner, params, 2, 8),
             "on the greedy step") != cold:
        fail("Flood engine: temperature 0 differs from the greedy step")
    flood(build_model_engine(runner, params, 2, 8, temperature=0.8,
                             seed=0), "temperature 0.8")
    return launches, failed


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------


def train(card):
    """4 optimizer steps of the port's Trainer on Ling-Lite at full width,
    depth cut to 4 layers: 16 B/param of training state (fp32 master,
    grad, two moments) is ~45 GB at 4 layers against ~269 GB at 28."""
    import dataclasses
    import torch
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.kernels import build
    from repro_torch.optim import adamw
    from repro_torch.training.trainer import TrainConfig, Trainer
    cfg = dataclasses.replace(get_config("ling-lite"), n_layers=4)
    B, S, accum, steps = 2, 1024, 2, 4
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = api.Runner(cfg, device="cuda")
    pipe = DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                       seq_len=S, batch_size=B, seed=0))
    trainer = Trainer(runner, pipe, TrainConfig(
        n_steps=steps, accum_steps=accum, log_every=1, seed=0,
        debug_guards=True))
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in adamw.leaves(trainer.params))
    print(f"[train] ling-lite d={cfg.d_model} layers={cfg.n_layers} (of 28) "
          f"experts={cfg.moe.n_experts} top{cfg.moe.top_k} vocab="
          f"{cfg.vocab_size}: {n_par / 1e9:.3f}B params, fp32 masters, init "
          f"{time.perf_counter() - t0:.1f}s; seq={S} microbatch={B} "
          f"accum={accum} remat=True router_warmup_steps="
          f"{cfg.moe.router_warmup_steps}")
    build.reset_launches()
    times = []
    try:
        for k in range(1, steps + 1):
            t0 = time.perf_counter()
            trainer.train(k)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        trainer.close()
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    step_s = sum(times[-2:]) / 2               # the median of two
    dev = trainer.timer.stats["device/step"].durations
    dev_ms = sum(list(dev)[-2:]) / 2e3
    for r in hist:
        print(f"[train] step={r['step']} loss={r['loss']:.4f} "
              f"ce={r['loss/ce']:.4f} aux={r['loss/aux']:.4f} "
              f"grad_norm={r['grad_norm']:.3f} lr={r['lr']:.2e} "
              f"skipped={r['skipped']} max_expert_frac="
              f"{r['router/max_expert_frac']:.3f}")
    per_step = {n: v / steps for n, v in launches.items()}
    want = step_launches(cfg, [accum])
    tok_s = B * S * accum / step_s
    print(f"[train] step times {[round(t, 3) for t in times]}s; median of "
          f"the last 2 {step_s:.3f}s (device time {dev_ms:.1f}ms); "
          f"{tok_s:.0f} tokens/s; peak max_memory_allocated "
          f"{peak / 2**30:.2f}GiB ({peak / 1e9:.2f}GB); launches per step "
          f"{per_step} expected {want}; commit_frac "
          f"{trainer.timer.gauges.get('commit_frac')} guard_n "
          f"{int(trainer.guard_state['n'])} [{card}]")
    if len(hist) != steps or not all(
            torch.isfinite(torch.tensor(r["loss"])) for r in hist):
        fail(f"training: losses {[r['loss'] for r in hist]}")
    if int(trainer.guard_state["n"]) != steps or \
            "commit_frac" not in trainer.timer.gauges:
        fail("training: the spike guard's commit was not reported per step")
    if per_step != want:
        fail(f"training launches per step {per_step} != {want}")
    if not peak < 80e9:
        fail(f"training peak memory {peak / 1e9:.2f} GB >= 80 GB")
    return launches


# ---------------------------------------------------------------------------
# phase 8b: checkpoint and exact resume mid-warmup
# ---------------------------------------------------------------------------


def step_launches(cfg, accums) -> dict:
    """Phase 8's launches per step, summed over steps at these accums."""
    n = sum(accums) * cfg.n_layers
    return {"fused_moe_ffn": 2 * n, "grouped_matmul_aligned": 6 * n,
            "grouped_matmul_wgrad": 3 * n, "paged_attn_scores_max": 0,
            "paged_attn_accumulate": 0, "normhead_matmul": 0, "wkv6": 0,
            "rwkv_decay": 0}


def train_resume(card):
    """Run A trains Ling-Lite (full width, 1 layer) 6 steps through the
    batch-size warmup with the router warmup active, checkpointing at 3
    and 6; a fresh Trainer B restores step_3 and trains to 6.  B's losses,
    params, moments and guard state must be A's bit for bit."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.models import prng
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import AccumWarmup
    from repro_torch.training.trainer import TrainConfig, Trainer
    cfg = dataclasses.replace(get_config("ling-lite"), n_layers=1)
    B, S, steps, every = 2, 1024, 6, 3
    bw = AccumWarmup(microbatch=B, start=2, end=8, warmup_steps=4,
                     increments=2)
    accums = [bw.accum_for(i) for i in range(steps)]
    n_par = sum(t.numel() for t in adamw.leaves(
        M.init_model(cfg, device="meta", masters=True)))
    ck_bytes = 12 * n_par                 # fp32 params and two moments
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))

    def make(ckpt_dir=True, every_=0):
        return Trainer(
            api.Runner(cfg, device="cuda"),
            DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                        seq_len=S, batch_size=B, seed=0)),
            TrainConfig(n_steps=steps, bs_warmup=bw, log_every=1, seed=0,
                        debug_guards=True,
                        checkpoint_dir=str(root) if ckpt_dir else None,
                        checkpoint_every=every_))

    def run(trainer, saves=None):
        """Step by step to `steps`; host-clock seconds per step (each
        ends synchronized; a checkpoint step includes its save's fetch)."""
        times = []
        for k in range(trainer.step + 1, steps + 1):
            t0 = time.perf_counter()
            trainer.train(k)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if saves is not None and k % every == 0:
                saves.append(trainer.pcache.last_save)
        return times

    def state(trainer):
        return (adamw.leaves(trainer.params)
                + adamw.leaves(trainer.opt_state)
                + adamw.leaves(trainer.guard_state))

    def ndiff(xs, ys) -> int:
        return sum(int((x.view(torch.int32) != y.view(torch.int32)).sum())
                   for x, y in zip(xs, ys))

    try:
        free = shutil.disk_usage(root).free
        need = 2 * ck_bytes + (1 << 30)
        print(f"[resume] ling-lite d={cfg.d_model} layers=1 (of 28): "
              f"{n_par / 1e9:.3f}B params, a checkpoint of "
              f"{ck_bytes / 1e9:.2f}GB (fp32 params, m, v); {root} has "
              f"{free / 1e9:.1f}GB free; seq={S} microbatch={B} accum "
              f"{accums} router_warmup_steps={cfg.moe.router_warmup_steps}")
        if free < need:
            fail(f"phase 8b: {root} has {free / 1e9:.2f} GB free; two "
                 f"checkpoints need {need / 1e9:.2f} GB")
        # the warmup noise: the step's key schedule and draws alone
        key = prng.prng_key(0, "cuda")
        T = B * S

        def draws(accum):
            rng = prng.fold_in(prng.fold_in(key, 1), 0)
            for k in range(accum):
                M.warmup_noise(cfg, prng.fold_in(rng, k) if accum > 1
                               else rng, 1, T)
        noise_ms = {a: cuda_ms(lambda: draws(a), iters=10)
                    for a in sorted(set(accums))}

        # run A: 6 steps, checkpoints at 3 and 6
        a = make(every_=every)
        saves = []
        build.reset_launches()
        try:
            times_a = run(a, saves)
        finally:
            a.close()                     # waits for the writers
        launches_a = dict(build.LAUNCHES)
        hist_a = [(r["loss"], r["grad_norm"]) for r in a.history]
        final_a = [t.detach().clone() for t in state(a)]
        del a
        gc.collect()
        torch.cuda.empty_cache()

        # run B: a fresh Trainer restores "latest", then step_3
        b = make()
        t0 = time.perf_counter()
        latest = b.restore("latest")
        torch.cuda.synchronize()
        latest_s = time.perf_counter() - t0
        n_latest = ndiff(final_a, state(b))
        t0 = time.perf_counter()
        b.restore(f"step_{every}")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        load_s = b.pcache.last_load["seconds"]
        stage = b._accum
        build.reset_launches()
        try:
            times_b = run(b)
        finally:
            b.close()
        launches_b = dict(build.LAUNCHES)
        hist_b = [(r["loss"], r["grad_norm"]) for r in b.history]
        n_diff = ndiff(final_a, state(b))
        del b
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    for i, (k, (loss, gn)) in enumerate(zip(accums, hist_a)):
        print(f"[resume] A step={i} accum={k} loss={loss:.6f} "
              f"grad_norm={gn:.4f} {times_a[i]:.3f}s"
              + (f" (with the step_{i + 1} save's fetch)"
                 if (i + 1) % every == 0 else ""))
    for i, (loss, gn) in enumerate(hist_b):
        print(f"[resume] B step={every + i} loss={loss:.6f} "
              f"grad_norm={gn:.4f} {times_b[i]:.3f}s")
    for name, s in zip(("step_3", "step_6"), saves):
        print(f"[resume] save {name}: {s['bytes'] / 1e9:.2f}GB fetch "
              f"{s['fetch_s']:.2f}s ({s['bytes'] / s['fetch_s'] / 1e9:.2f}"
              f"GB/s) write {s['write_s']:.2f}s "
              f"({s['bytes'] / s['write_s'] / 1e9:.2f}GB/s, background)")
    print(f"[resume] restore latest={latest}: {latest_s:.2f}s "
          f"({ck_bytes / latest_s / 1e9:.2f}GB/s), {n_latest} elements "
          f"apart from A's final state; restore step_{every}: "
          f"{restore_s:.2f}s ({ck_bytes / restore_s / 1e9:.2f}GB/s; the "
          f"load from disk to the card {load_s:.2f}s); stage carried "
          f"{stage}")
    print(f"[resume] warmup noise (keys and draws, {cfg.n_layers} layer(s) "
          f"of ({T}, {cfg.moe.n_experts})) per step: " + ", ".join(f"accum {k} {v:.3f}ms"
                                   for k, v in noise_ms.items())
          + f"; B's launches {launches_b}; [{card}]")
    failed = []
    if latest != f"step_{steps}" or n_latest:
        failed.append(f"restore('latest') gave {latest} with {n_latest} "
                      f"elements apart from A's final state")
    if stage != bw.accum_for(every):
        failed.append(f"accum stage {stage} != {bw.accum_for(every)}")
    if launches_a != step_launches(cfg, accums) or \
            launches_b != step_launches(cfg, accums[every:]):
        failed.append(f"launches A {launches_a} B {launches_b}, expected "
                      f"{step_launches(cfg, accums)} and "
                      f"{step_launches(cfg, accums[every:])}")
    if hist_b != hist_a[every:] or n_diff:
        failed.append(f"B parts from A: losses {hist_b} vs "
                      f"{hist_a[every:]}, {n_diff} state elements")
        # tell the step apart from the resume: two uninterrupted runs
        runs = []
        for _ in range(2):
            c = make(ckpt_dir=False)
            try:
                run(c)
            finally:
                c.close()
            runs.append([t.detach().clone() for t in state(c)])
            del c
        print(f"[resume] two uninterrupted runs differ in "
              f"{ndiff(*runs)} state elements")
    if failed:
        fail("phase 8b: " + "; ".join(failed))
    return {"a": launches_a, "b": launches_b}


def end_to_end(cfg, params, gen):
    """Teacher-force one request through the kernels and through the
    plain modes; compare the logits of every step."""
    import torch
    from repro_torch.models import model as M
    dev = "cuda"
    B, C, ps, n_lp, steps = 8, 64, 16, 32, 8
    tokens = torch.randint(0, cfg.vocab_size, (C + steps,), generator=gen,
                           device=dev)
    table = torch.zeros((B, n_lp), dtype=torch.int32, device=dev)
    table[0, :(C + steps + ps - 1) // ps] = torch.arange(
        1, 1 + (C + steps + ps - 1) // ps, dtype=torch.int32, device=dev)
    active = torch.zeros((B,), dtype=torch.bool, device=dev)
    active[0] = True

    def run(flags):
        pools = M.init_paged_caches(cfg, 1 + n_lp, ps, dev)
        out = []
        with torch.no_grad():
            lg, _ = M._paged_prefill_logits(cfg, params, pools, tokens[:C],
                                            0, C, table[0], page_size=ps,
                                            flags=flags)
            out.append(lg[0])
            for i in range(steps):
                tok = torch.zeros((B,), dtype=torch.long, device=dev)
                tok[0] = tokens[C + i]
                pos = torch.zeros((B,), dtype=torch.long, device=dev)
                pos[0] = C + i
                lg, _ = M._paged_decode_logits(cfg, params, pools, tok, pos,
                                               table, active, page_size=ps,
                                               flags=flags)
                out.append(lg[0])
        return torch.stack(out)

    from repro_torch.kernels import build
    build.reset_launches()
    fused = run(M.RunFlags())
    torch.cuda.synchronize()
    n_k5 = build.LAUNCHES["normhead_matmul"]
    if n_k5 != 1 + steps:
        fail(f"end to end: normhead_matmul launched {n_k5} times, expected "
             f"{1 + steps} (one per chunk and per step)")
    plain = run(M.RunFlags(moe_dispatch="ragged", paged_attn="gathered"))
    err = (fused - plain).abs().max().item()
    # "ragged" rounds the expert hidden and its scatter-add to bf16 where
    # K1 keeps fp32; over 28 layers that is bf16-level drift in the
    # residual stream, so the logits are held to 2^-5 of their largest
    tol = 2.0 ** -5 * plain.abs().max().item()
    agree = (fused.argmax(-1) == plain.argmax(-1)).float().mean().item()
    print(f"[e2e] 1 prefill chunk + {steps} decode steps: logits "
          f"max_abs_err={err:.4e} (tolerance {tol:.4e}) greedy agreement="
          f"{agree:.3f}; normhead_matmul launches {n_k5}")
    if not err <= tol:
        fail(f"end-to-end logits: {err} > {tol}")
    return err, agree


def main():
    src = Path(__file__).resolve().parent / "src"
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "a CUDA card")
    # fp32 products (plain versions, router, NormHead) stay full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        from repro_torch.configs.base import get_config
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"cannot import the port from {src}: {e}")

    # -- 1. the card ------------------------------------------------------
    card = card_line()
    print(card)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"devices={torch.cuda.device_count()}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    for name in build.SIGNATURES:
        build.entry(name)
    print(f"[build] {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.1f}s: "
          f"{sorted(p.name for p in libs.values())}")
    for p in libs.values():
        log = p.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "Used" in line or "spill" in line:
                    print(f"[build] {p.stem}: {line.strip()}")

    # -- 3. per-kernel checks ----------------------------------------------
    cfg = get_config("ling-lite")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    k1 = {"decode": check_k1(cfg, 8, gen), "prefill": check_k1(cfg, 64, gen),
          "verify": check_k1(cfg, 40, gen),
          "train": check_k1(cfg, 2048, gen)}
    torch.cuda.empty_cache()
    k3, k4 = {}, {}
    for label, kw in PA_CASES.items():
        k3[label], k4[label] = check_pa(cfg, label,
                                        paged_case(cfg, gen=gen, **kw))
    k2, wgrad = check_k2(cfg, gen)
    k5 = {label: check_k5(label, *k5_case(arch, T, gen))
          for label, (arch, T) in K5_CASES.items()}
    k6 = {label: check_k6(label, *k6_case(*case, gen))
          for label, case in K6_CASES.items()}
    decay = {label: check_decay(label, *decay_case(M, dt, gen))
             for label, (M, dt) in DECAY_CASES.items()}
    results = {"fused_moe_ffn": k1,
               "grouped_matmul_aligned": k2,
               "grouped_matmul_wgrad": wgrad,
               "paged_attn_scores_max": k3, "paged_attn_accumulate": k4,
               "normhead_matmul": k5, "wkv6": k6, "rwkv_decay": decay}
    gc.collect()
    torch.cuda.empty_cache()

    # -- 4. gradients --------------------------------------------------------
    check_grads(cfg, gen)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5. serving ---------------------------------------------------------
    from repro_torch import api
    t0 = time.perf_counter()
    params = api.Runner(cfg, device="cuda").init_params(0)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"[serve] ling-lite {cfg.n_layers} layers d={cfg.d_model} "
          f"experts={cfg.moe.n_experts} top{cfg.moe.top_k}: {n_par / 1e9:.2f}B "
          f"params, {sum(t.numel() * t.element_size() for t in _leaves(params)) / 2**30:.1f}GiB, "
          f"init {time.perf_counter() - t0:.1f}s (depth not cut)")
    base, serve_launches = serve(cfg, params)

    # -- 6. end to end ------------------------------------------------------
    end_to_end(cfg, params, gen)

    # -- 6b. sampling and speculative decoding -------------------------------
    spec_launches = serve_sampled(cfg, params, base, card)

    # -- 7. rwkv6 serving ---------------------------------------------------
    del params          # 31 GiB of bf16 serving weights
    gc.collect()
    torch.cuda.empty_cache()
    rwkv_launches, rwkv_failed = rwkv_serve(card)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8. training --------------------------------------------------------
    train_launches = train(card)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8b. checkpoint and exact resume ---------------------------------------
    resume_launches = train_resume(card)

    # -- 9. results ---------------------------------------------------------
    # (source, TPU kernel it replaces, the row's shape, the path whose
    # launch count the row reports)
    meta = {"fused_moe_ffn": ("src/repro_torch/kernels/csrc/fused_moe_ffn.cu",
                              "src/repro/kernels/grouped_matmul.py:264",
                              "train", "train"),
            "grouped_matmul_aligned": (
                "src/repro_torch/kernels/csrc/grouped_matmul.cu",
                "src/repro/kernels/grouped_matmul.py:124", "up d->ff",
                "train"),
            "grouped_matmul_wgrad": (
                "src/repro_torch/kernels/csrc/grouped_matmul.cu",
                "src/repro/core/moe.py:179", "train", "train"),
            "paged_attn_scores_max": ("src/repro_torch/kernels/csrc/paged_attn.cu",
                                      "src/repro/kernels/paged_attn.py:182",
                                      "decode", "serve"),
            "paged_attn_accumulate": ("src/repro_torch/kernels/csrc/paged_attn.cu",
                                      "src/repro/kernels/paged_attn.py:229",
                                      "decode", "serve"),
            "normhead_matmul": ("src/repro_torch/kernels/csrc/normhead.cu",
                                "src/repro/kernels/normhead.py:54",
                                "rwkv6 head T=8", "rwkv_serve"),
            "wkv6": ("src/repro_torch/kernels/csrc/wkv6.cu",
                     "src/repro/kernels/wkv6.py:62", "prefill",
                     "rwkv_serve"),
            # no TPU kernel: the reference's jnp decay
            "rwkv_decay": ("src/repro_torch/kernels/csrc/rwkv_decay.cu",
                           "src/repro/models/rwkv6.py:112", "prefill",
                           "rwkv_serve")}
    launches = {"serve": serve_launches, "spec": spec_launches,
                "rwkv_serve": rwkv_launches, "train": train_launches,
                "resume_a": resume_launches["a"],
                "resume_b": resume_launches["b"]}
    rows = []
    for name, shapes in results.items():
        src_path, replaces, main_shape, path = meta[name]
        d = shapes[main_shape]
        rows.append({"name": name, "route": "cuda", "source": src_path,
                     "replaces": replaces,
                     "launches": launches[path][name],
                     "launches_by_path": {p: launches[p].get(name, 0)
                                          for p in launches},
                     "max_abs_err": max(s["max_abs_err"]
                                        for s in shapes.values()),
                     "tolerance": d["tolerance"],
                     "ms": d["ms"], "plain_ms": d["plain_ms"],
                     "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
                     "library_ms": d["library_ms"],
                     **{key: d[key] for key in ("device_ms", "host_ms",
                                                "product_ms") if key in d},
                     "shapes": shapes})
    print(json.dumps({"kernels": rows}))
    if rwkv_failed:
        fail("; ".join(rwkv_failed))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
