#!/usr/bin/env python3
"""Where the serving time goes in the PyTorch/CUDA port, on one card.

    python3 scripts/profile_torch_serve.py

Two serving paths, each with random weights from
torch.Generator(device="cuda").manual_seed(0), one after the other:

Ling-Lite paged online serving (full width) behind the same OnlineEngine
geometry as chip_smoke.py (8 slots, page 16, prefill chunk 64, context
512): submits 16 requests with 64-256-token prompts and 32 new tokens at
once, skips the first 16 ticks (all 8 slots are decoding by then while
prefill chunks continue), then

  * times 12 prefill chunks and decode ticks on the host clock
    (each ends in torch.cuda.synchronize), and
  * traces the same kind of window with torch.profiler.

rwkv6-3b dense serving (full width, 32 layers): the Runner's greedy
prefill of 8 prompts of 512 tokens and decode ticks over the 8
sequences, as chip_smoke.py phase 7 runs them; after a warm-up it times
one prefill and 8 ticks on the host clock, then traces one prefill and 8
ticks.

Each trace prints device time by kernel (top 20), grouped by layer of
the port (K1..K6, the rwkv6 decay, dense GEMMs, everything else), and
the device's busy time and idle share of the window's wall time.

    python3 scripts/profile_torch_serve.py [--only ling-lite|rwkv6-3b]
                                           [--src DIR]

`--only` runs one of the two paths; `--src` runs the port found in DIR
(for instance an unpacked parent commit's `src`), so that two versions
can be compared in one call on one card.

Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

SKIP, TICKS = 16, 12
RWKV_B, RWKV_S, RWKV_TICKS = 8, 512, 8

GROUPS = (("K1 fused_moe_ffn", ("moe_up", "moe_down", "moe_combine")),
          ("K5 normhead_matmul", ("normhead_kernel",)),
          ("K6 wkv6", ("wkv6_kernel",)),
          ("rwkv6 decay", ("rwkv_decay_",)),
          ("K3 paged_attn_scores_max", ("pa_scores_max_kernel",)),
          ("K4 paged_attn_accumulate", ("pa_accumulate_kernel",)),
          # cuBLAS on Hopper names its kernels nvjet_* / sm90_xmma_*
          ("dense GEMMs (torch.matmul)", ("gemm", "gemv", "xmma", "cutlass",
                                          "cublas", "splitk", "nvjet")),
          ("sort / scan / index", ("sort", "scan", "radix", "index",
                                   "gather", "scatter", "bincount",
                                   "histogram")),
          ("reductions / softmax / topk", ("reduce", "softmax", "topk",
                                           "norm", "max", "sum")),
          ("elementwise / copies", ("elementwise", "copy", "fill", "cat",
                                    "vectorized")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def trace(label: str, window):
    """Run `window()` under torch.profiler and print device time by kernel
    and by group, and the device's idle share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for ev in prof.key_averages():
        # kernel rows only: CPU ops carry their kernels' time too
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"[profile] {label}: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.1%}")
    groups = defaultdict(float)
    for ms, _, name in rows:
        groups[group_of(name)] += ms
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {g:32s} {ms:9.2f} ms  {ms / busy:6.1%} of device")
    for ms, n, name in rows[:20]:
        print(f"[profile]   {ms:9.3f} ms  x{n:<6d} {name[:90]}")


def ling_online():
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.serving.online import (OnlineConfig, OnlineEngine,
                                            OnlineRequest)
    cfg = get_config("ling-lite")
    runner = api.Runner(cfg, device="cuda")
    params = runner.init_params(0)
    eng = OnlineEngine(runner, params, OnlineConfig(
        max_slots=8, max_context=512, page_size=16, prefill_chunk=64))
    rs = np.random.RandomState(0)
    lens = rs.randint(64, 257, size=16)
    eng.submit_many([OnlineRequest(rid=i, prompt=rs.randint(
        0, cfg.vocab_size, n).astype(np.int32), max_new=32)
        for i, n in enumerate(lens)])
    for _ in range(SKIP):
        eng.tick()
    torch.cuda.synchronize()

    # host-clock phase times
    pre, dec = [], []
    for _ in range(TICKS):
        eng.ticks += 1
        eng._admit()
        n0 = eng.step_calls["prefill"]
        t0 = time.perf_counter()
        eng._prefill_tick()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng._decode_tick()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if eng.step_calls["prefill"] > n0:
            pre.append(1e3 * (t1 - t0))
        dec.append(1e3 * (t2 - t1))
    med = lambda xs: float(np.median(xs)) if xs else float("nan")
    print(f"[host] ling-lite: prefill chunk median {med(pre):.2f} ms over "
          f"{len(pre)}; decode tick median {med(dec):.2f} ms over "
          f"{len(dec)} (active slots now {int(eng.active.sum())})")

    def window():
        for _ in range(TICKS):
            eng.tick()
    trace(f"ling-lite, {TICKS} ticks", window)


def rwkv_dense():
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.configs.base import get_config
    cfg = get_config("rwkv6-3b")
    runner = api.Runner(cfg, device="cuda")
    params = runner.init_params(0)
    prefill, decode = runner.make_prefill(), runner.make_decode_step()
    prompts = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (RWKV_B, RWKV_S))).cuda()

    def window():
        tok, caches = prefill(params, {"tokens": prompts})
        for pos in range(RWKV_S, RWKV_S + RWKV_TICKS):
            tok, caches = decode(params, caches, tok, pos)

    window()                                         # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, caches = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for pos in range(RWKV_S, RWKV_S + RWKV_TICKS):
        tok, caches = decode(params, caches, tok, pos)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"[host] rwkv6-3b: prefill B={RWKV_B} S={RWKV_S} "
          f"{1e3 * (t1 - t0):.2f} ms; decode tick "
          f"{1e3 * (t2 - t1) / RWKV_TICKS:.2f} ms (mean of {RWKV_TICKS})")
    del caches
    trace(f"rwkv6-3b, 1 prefill + {RWKV_TICKS} ticks", window)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("ling-lite", "rwkv6-3b"))
    ap.add_argument("--src", default=str(Path(__file__).resolve()
                                         .parents[1] / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import gc
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: needs a CUDA card")
    import repro_torch
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    print(f"[profile] port from {Path(repro_torch.__file__).parent}")
    if args.only != "rwkv6-3b":
        ling_online()
        gc.collect()
        torch.cuda.empty_cache()
    if args.only != "ling-lite":
        rwkv_dense()


if __name__ == "__main__":
    main()
