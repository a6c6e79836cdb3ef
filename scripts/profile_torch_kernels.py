#!/usr/bin/env python3
"""Times the serving kernels on one card, at the shapes of chip_smoke.py's
phase-3 cases:

  * `pa`: K3 / K4, the two passes of paged attention (`chip_smoke.PA_CASES`:
    decode B=8, Q=1 over contexts with inactive slots, and a prefill chunk
    B=1, Q=64; Ling-Lite's 4 KV heads, g=4, head_dim 128, page 16, 32
    logical pages);
  * `rwkv`: K5, the fused NormHead logits (`chip_smoke.K5_CASES`: Ling-Lite's
    and rwkv6-3b's fp32 heads against 1-65 bf16 rows of x), and K6, the
    WKV6 recurrence (`chip_smoke.K6_CASES`: rwkv6-3b's 8 x 512-token
    prefill, a B = 8 decode tick with the state updated in place, T = 100
    in fp32, and decays near 0 and near 1).

    python3 scripts/profile_torch_kernels.py [--only pa|rwkv] [--src DIR]
                                             [--iters N]

`--src` times the port found in DIR (for instance an unpacked parent
commit's `src`) on this checkout's cases, so that two versions can be
compared in one call on one card.  For each kernel and case it prints,
with chip_smoke.py's timers:

  * wrapper: CUDA events around one call from an idle queue (`cuda_ms`,
    the kernels line's `ms`: the host's dispatch is inside it);
  * device: the same with the queue held by a sleep kernel, so only the
    card's time remains (`device_ms`);
  * host: the wrapper's dispatch alone, on the host clock over calls
    that do not wait for the card (`host_ms`: the median of 5 means of
    `--iters` calls);
  * profiler: the kernels' own time per call by torch.profiler
    (`kernel_split`), split by kernel name.

Needs a CUDA card; prints the card's name and power limit first and last.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def pa_calls(cs, gen):
    """(tag, kernel, label, fn, kernel names) of K3 / K4's cases."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import paged_attn as pa
    cfg = get_config("ling-lite")
    # the passes' kernel names (the split walk's, and within them the
    # first port's)
    names = ("scores_max_kernel", "accumulate_kernel")
    for label, kw in cs.PA_CASES.items():
        gq, k_pool, v_pool, table, mask4 = cs.paged_case(cfg, gen=gen, **kw)
        m = pa.paged_attn_scores_max_ref(gq, k_pool, table, mask4)
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        yield ("pa", "paged_attn_scores_max", label,
               lambda: pa.paged_attn_scores_max(gq, k_pool, table, mask4),
               names)
        yield ("pa", "paged_attn_accumulate", label,
               lambda: pa.paged_attn_accumulate(gq, k_pool, v_pool, table,
                                                mask4, m_safe), names)


def rwkv_calls(cs, gen):
    """(tag, kernel, label, fn, kernel names) of K5's and K6's cases."""
    from repro_torch.kernels import normhead as nh
    from repro_torch.kernels import wkv6 as wk
    for label, (arch, T) in cs.K5_CASES.items():
        x, w = cs.k5_case(arch, T, gen)
        yield ("rwkv", "normhead_matmul", label,
               lambda: nh.normhead_matmul(x, w), ("normhead_kernel",))
    for label, case in cs.K6_CASES.items():
        r, k, v, w, u, s0 = cs.k6_case(*case, gen)
        yield ("rwkv", "wkv6", label,
               lambda: wk.wkv6(r, k, v, w, u, s0, out_state=s0),
               ("wkv6_kernel",))


GROUPS = {"pa": pa_calls, "rwkv": rwkv_calls}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=sorted(GROUPS))
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    from repro_torch.kernels import build
    print(cs.card_line())
    print(f"[profile] port from {build.__file__}")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    for group in [args.only] if args.only else sorted(GROUPS):
        for tag, name, label, fn, names in GROUPS[group](cs, gen):
            w = cs.cuda_ms(fn, iters=args.iters)
            d = cs.device_ms(fn, args.iters)
            h = cs.host_ms(fn, args.iters)
            kern = cs.kernel_split(fn, names, args.iters) or {}
            split = ", ".join(f"{k} {v:.4f}" for k, v in kern.items()
                              if v > 0)
            print(f"[{tag}] {name} {label}: wrapper {w:.4f} ms, device "
                  f"{d:.4f} ms, host {h:.4f} ms, profiler "
                  f"{sum(kern.values()):.4f} ms ({split or 'no device time'})")
    print(cs.card_line())


if __name__ == "__main__":
    main()
