#!/usr/bin/env python3
"""Times K3 / K4 (two-pass paged attention) on one card, at the shapes
of chip_smoke.py's phase-3 cases (`chip_smoke.PA_CASES`: decode B=8,
Q=1 over contexts with inactive slots, and a prefill chunk B=1, Q=64;
Ling-Lite's 4 KV heads, g=4, head_dim 128, page 16, 32 logical pages).

    python3 scripts/profile_torch_pa.py [--src DIR] [--iters N]

`--src` times the port found in DIR (for instance an unpacked parent
commit's `src`) on this checkout's cases, so that two versions can be
compared in one call on one card.  For each pass and shape it prints,
with chip_smoke.py's timers:

  * wrapper: CUDA events around one call from an idle queue (`cuda_ms`,
    the kernels line's `ms`: the host's dispatch is inside it);
  * device: the same with the queue held by a sleep kernel, so only the
    card's time remains (`device_ms`);
  * host: the wrapper's dispatch alone, on the host clock over calls
    that do not wait for the card (`host_ms`: the median of 5 means of
    `--iters` calls);
  * profiler: the kernels' own time per call by torch.profiler
    (`kernel_split`).

Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the passes' kernel names (the split walk's, and within them the first
# port's)
KERNELS = ("scores_max_kernel", "accumulate_kernel")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import paged_attn as pa
    print(cs.card_line())
    print(f"[pa] port from {pa.__file__}")
    cfg = get_config("ling-lite")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cases = {label: cs.paged_case(cfg, gen=gen, **kw)
             for label, kw in cs.PA_CASES.items()}
    for label, (gq, k_pool, v_pool, table, mask4) in cases.items():
        m = pa.paged_attn_scores_max_ref(gq, k_pool, table, mask4)
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        calls = {
            "paged_attn_scores_max": lambda: pa.paged_attn_scores_max(
                gq, k_pool, table, mask4),
            "paged_attn_accumulate": lambda: pa.paged_attn_accumulate(
                gq, k_pool, v_pool, table, mask4, m_safe)}
        for name, fn in calls.items():
            w = cs.cuda_ms(fn, iters=args.iters)
            d = cs.device_ms(fn, args.iters)
            h = cs.host_ms(fn, args.iters)
            kern = cs.kernel_split(fn, KERNELS, args.iters) or {}
            split = ", ".join(f"{k} {v:.4f}" for k, v in kern.items()
                              if v > 0)
            print(f"[pa] {name} {label}: wrapper {w:.4f} ms, device "
                  f"{d:.4f} ms, host {h:.4f} ms, profiler "
                  f"{sum(kern.values()):.4f} ms "
                  f"({split or 'no device time'})")
    print(cs.card_line())


if __name__ == "__main__":
    main()
