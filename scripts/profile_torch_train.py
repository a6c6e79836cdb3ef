#!/usr/bin/env python3
"""Where the training time goes in the PyTorch/CUDA port, on one card.

    python3 scripts/profile_torch_train.py

Builds the training cell of chip_smoke.py: Ling-Lite at full width cut to
4 layers, fp32 masters from torch.Generator(device="cuda").manual_seed(0),
the port's Trainer at seq 1024, microbatch 2, accum 2 (remat, fused MoE,
spike guard, router warmup active).  Runs 2 steps to warm up, times 2
steps on the host clock (each ends in torch.cuda.synchronize), then traces
one more step with torch.profiler and prints device time by kernel (top
20), grouped by layer of the port (K1, K2, the weight gradient,
attention, dense GEMMs, ...), and the device's idle share of the step's
wall time.

Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

GROUPS = (("K1 fused_moe_ffn", ("moe_up", "moe_down", "moe_combine")),
          ("K2 grouped_matmul_aligned", ("grouped_mm_kernel",)),
          ("grouped_matmul_wgrad", ("grouped_wgrad_kernel",)),
          ("attention (SDPA)", ("fmha", "attention", "flash", "efficient")),
          # cuBLAS on Hopper names its kernels nvjet_* / sm90_xmma_*
          ("dense GEMMs (torch.matmul)", ("gemm", "gemv", "xmma", "cutlass",
                                          "cublas", "splitk", "nvjet")),
          ("sort / scan / index", ("sort", "scan", "radix", "index",
                                   "gather", "scatter", "histogram")),
          ("reductions / softmax / topk", ("reduce", "softmax", "topk",
                                           "norm", "max", "sum")),
          ("elementwise / copies", ("elementwise", "copy", "fill", "cat",
                                    "vectorized", "where")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA card")
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.training.trainer import TrainConfig, Trainer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("ling-lite"), n_layers=4)
    pipe = DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                       seq_len=1024, batch_size=2, seed=0))
    trainer = Trainer(api.Runner(cfg, device="cuda"), pipe, TrainConfig(
        n_steps=5, accum_steps=2, log_every=1, seed=0))
    try:
        trainer.train(2)
        torch.cuda.synchronize()
        times = []
        for k in (3, 4):
            t0 = time.perf_counter()
            trainer.train(k)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        print(f"[host] step times {[round(t, 1) for t in times]} ms")

        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train(5)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        trainer.close()
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
    print(f"[profile] 1 step: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.1%}")
    groups = defaultdict(float)
    for ms, _, name in rows:
        groups[group_of(name)] += ms
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {g:32s} {ms:9.2f} ms  {ms / busy:6.1%} of device")
    for ms, n, name in rows[:20]:
        print(f"[profile]   {ms:9.3f} ms  x{n:<6d} {name[:90]}")


if __name__ == "__main__":
    main()
