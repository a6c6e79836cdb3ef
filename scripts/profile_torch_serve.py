#!/usr/bin/env python3
"""Where the serving time goes in the PyTorch/CUDA port, on one card.

    python3 scripts/profile_torch_serve.py

Builds full-width Ling-Lite (random weights from
torch.Generator(device="cuda").manual_seed(0)) behind the same
OnlineEngine geometry as chip_smoke.py (8 slots, page 16, prefill chunk
64, context 512), submits 16 requests with 64-256-token prompts and 32
new tokens at once, skips the first 16 ticks (all 8 slots are decoding
by then while prefill chunks continue), then:

  * times 12 prefill chunks and decode ticks on the host clock
    (each ends in torch.cuda.synchronize), and
  * traces the same kind of window with torch.profiler and prints device
    time by kernel (top 20), grouped by layer of the port (K1, K3, K4,
    dense GEMMs, everything else), and the device's idle share of the
    window's wall time.

Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SKIP, TICKS = 16, 12

GROUPS = (("K1 fused_moe_ffn", ("moe_up", "moe_down", "moe_combine")),
          ("K3 paged_attn_scores_max", ("scores_max_kernel",)),
          ("K4 paged_attn_accumulate", ("accumulate_kernel",)),
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


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: needs a CUDA card")
    import numpy as np
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.serving.online import (OnlineConfig, OnlineEngine,
                                            OnlineRequest)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
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
    print(f"[host] prefill chunk median {med(pre):.2f} ms over {len(pre)}; "
          f"decode tick median {med(dec):.2f} ms over {len(dec)} "
          f"(active slots now {int(eng.active.sum())})")

    # device time by kernel over a window of ticks
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TICKS):
            eng.tick()
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
    print(f"[profile] {TICKS} ticks: wall {wall_ms:.1f} ms, device "
          f"busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.1%}")
    groups = defaultdict(float)
    for ms, _, name in rows:
        groups[group_of(name)] += ms
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {g:32s} {ms:9.2f} ms  {ms / busy:6.1%} of device")
    for ms, n, name in rows[:20]:
        print(f"[profile]   {ms:9.3f} ms  x{n:<6d} {name[:90]}")


if __name__ == "__main__":
    main()
