#!/usr/bin/env python3
"""How far rounding alone moves full-width rwkv6-3b's logits on one card:
chip_smoke.py phase 7's prefill-vs-ticks comparison over several prompts,
on the kernels and on the plain versions of K5 and K6, with bf16 and with
fp32 activations, and which op lets a prefill and the decode ticks part.

    python3 scripts/torch_rwkv_rounding.py [--prompts N] [--n T] [--src DIR]

The weights are phase 7's (seed 0, serving storage) and prompt i is the
first T tokens of row i of its prompts (numpy seed 0), so prompt 0 is
the one phase 7 checks.  It prints, in order:

  * the decay of layer 0 on the port's kernel, with its LoRA products in
    fp32 (the plain version) and in fp64 rounded once, on 4096 rows given
    1, 8, 64 and 4096 at a time: the elements that differ from the
    one-row result, and the time of one call (CUDA events, median of 20);
  * for each prompt with bf16 activations and for prompt 0 with fp32,
    each op of the rwkv block repeated one position at a time on the
    prefill's inputs, as the ticks give them: the elements that differ
    from the prefill's;
  * for each prompt and activation dtype, as a share of the largest
    logit of the plain run's prefill: kernels, one T-token prefill
    against T decode ticks on K5 and K6; plain, the same through the
    plain K5 and K6 (`chip_smoke.plain_k5_k6`); k-vs-p, the kernels'
    logits against the plain ones, prefill and last tick, the larger;
    and each run's greedy token;
  * on prompt 0 with bf16 activations, every K6 call of the kernels'
    prefill and ticks repeated by the plain version on the same inputs:
    the largest y difference beyond one bf16 ulp as a share of the
    call's largest |y| (chip_smoke.py phase 3's measure, held there to
    1e-4), the count of y elements that differ at all, and the largest
    state difference as a share of the state's largest element.

`--src` runs the port found in DIR (for instance an unpacked parent
commit's `src`), so two versions can be compared in one call.  Needs a
CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def row_invariance(cfg, params, tokens):
    """Run one prefill over `tokens` (1, n) and repeat every call of the
    rwkv block's ops one position at a time on the same inputs, as the
    decode ticks give them: {op: (calls, elements that differ, elements)}.
    An op whose result for a position depends on how many positions it
    is given lets the prefill and the ticks part before any rounding
    chaos downstream."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import rwkv6 as R
    seen = {}

    def tally(name, got, want):
        c, d, e = seen.get(name, (0, 0, 0))
        seen[name] = (c + 1, d + int((got != want).sum()), e + got.numel())

    orig = {"norm": L.apply_norm, "proj": R._projections,
            "out": R._output, "cmix": R.channel_mix, "wkv6": kops.wkv6}

    def norm(cfg, p, x):
        out = orig["norm"](cfg, p, x)
        rows = torch.cat([orig["norm"](cfg, p, x[i:i + 1])
                          for i in range(x.shape[0])])
        tally("rms norm", out, rows)
        return out

    def proj(cfg, p, x, x_prev):
        outs = orig["proj"](cfg, p, x, x_prev)
        per = [orig["proj"](cfg, p, x[:, i].contiguous(),
                            x_prev[:, i].contiguous())
               for i in range(x.shape[1])]
        for j, name in enumerate("rkvwg"):
            tally(f"projection {name}", outs[j],
                  torch.stack([q[j] for q in per], 1))
        return outs

    def out(cfg, p, y, g):
        o = orig["out"](cfg, p, y, g)
        tally("time-mix output", o, torch.stack(
            [orig["out"](cfg, p, y[:, i].contiguous(), g[:, i].contiguous())
             for i in range(y.shape[1])], 1))
        return o

    def cmix(cfg, p, h, h_prev):
        part, gate = orig["cmix"](cfg, p, h, h_prev)
        per = [orig["cmix"](cfg, p, h[i:i + 1], h_prev[i:i + 1])
               for i in range(h.shape[0])]
        tally("channel-mix partial", part, torch.cat([q[0] for q in per]))
        tally("channel-mix gate", gate, torch.cat([q[1] for q in per]))
        return part, gate

    def wkv6(r, k, v, w, u, state, *, out_state=None):
        s0 = state.clone()
        y, sT = orig["wkv6"](r, k, v, w, u, state, out_state=out_state)
        ys, s = [], s0
        for i in range(r.shape[1]):
            yi, s = orig["wkv6"](*(t[:, i:i + 1].contiguous()
                                   for t in (r, k, v, w)), u, s)
            ys.append(yi)
        tally("wkv6 y", y, torch.cat(ys, 1))
        tally("wkv6 state", sT, s)
        return y, sT

    L.apply_norm, R._projections, R._output = norm, proj, out
    R.channel_mix, kops.wkv6 = cmix, wkv6
    try:
        with torch.no_grad():
            M.prefill_logits(cfg, params, {"tokens": tokens})
    finally:
        L.apply_norm, R._projections, R._output = (
            orig["norm"], orig["proj"], orig["out"])
        R.channel_mix, kops.wkv6 = orig["cmix"], orig["wkv6"]
    return seen


def decay_forms(la, lb, w0, d, sizes=(1, 8, 64, 4096), reps=20):
    """rwkv6's decay w = exp(-exp(w0 + tanh(x A) B)) of bf16 rows x, on
    the port's kernel (`kernels.rwkv_decay`), with its two products in
    fp32 (the plain version) and in fp64 rounded once to fp32, each run
    on the same rows at every size in `sizes`: how many elements of w
    differ from the 1-row result, and the time of one call at each size
    (CUDA events, median of `reps`)."""
    import torch
    from repro_torch.kernels import rwkv_decay as dk
    g = torch.Generator(device=la.device).manual_seed(1)
    x = torch.randn(max(sizes), d, device=la.device, generator=g).bfloat16()
    forms = {
        "kernel (the port)": lambda xw: dk.rwkv_decay(xw, la, lb, w0),
        "fp32 products (plain)": lambda xw: dk.rwkv_decay_ref(
            xw, la, lb, w0),
        "fp64 products, rounded once": lambda xw: torch.exp(-torch.exp((
            w0.double() + torch.tanh(xw.double() @ la.double())
            @ lb.double()).float())),
    }
    for name, f in forms.items():
        one = torch.cat([f(x[i:i + 1]) for i in range(max(sizes))])
        diffs, times = [], []
        for m in sizes:
            out = torch.cat([f(x[i:i + m]) for i in range(0, max(sizes), m)])
            diffs.append(int((out != one).sum()))
            ts = []
            for _ in range(reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                f(x[:m])
                b.record()
                b.synchronize()
                ts.append(a.elapsed_time(b))
            times.append(sorted(ts)[reps // 2])
        print(f"[rounding] decay, {name}: rows {list(sizes)} differ "
              f"from one row at a time in {diffs} of {one.numel()} elements;"
              f" ms per call {[round(t, 4) for t in times]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import wkv6 as wk
    print(cs.card_line())
    print(f"[rounding] port from {wk.__file__}")
    cfg = get_config("rwkv6-3b")
    params = api.Runner(cfg, device="cuda").init_params(0)
    prompts = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (max(8, args.prompts), 512))).cuda()
    rel = lambda a, b, top: (a - b).abs().max().item() / top
    tm = params["blocks"]["tmix"]
    decay_forms(tm["w_lora_a"][0].float(), tm["w_lora_b"][0].float(),
                tm["w0"][0].float(), cfg.d_model)
    for dt, count in (("bfloat16", max(1, args.prompts)), ("float32", 1)):
        c = dataclasses.replace(cfg, compute_dtype=dt)
        for i in range(count):
            for op, (calls, differ, elems) in row_invariance(
                    c, params, prompts[i:i + 1, :args.n]).items():
                print(f"[rounding] {dt} prompt {i}, {op}: {calls} calls, "
                      f"{differ} of {elems} elements differ between the "
                      f"prefill and one position at a time")
    for dt in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, compute_dtype=dt)
        for i in range(args.prompts):
            p = prompts[i:i + 1, :args.n]
            ka, kb = cs.prefill_and_ticks(c, params, p)
            with cs.plain_k5_k6():
                pa, pb = cs.prefill_and_ticks(c, params, p)
            top = pa.abs().max().item()
            toks = [int(t.argmax(-1).item()) for t in (ka, kb, pa, pb)]
            print(f"[rounding] {dt} prompt {i}: kernels "
                  f"{rel(ka, kb, top):.3e} plain {rel(pa, pb, top):.3e} "
                  f"k-vs-p {max(rel(ka, pa, top), rel(kb, pb, top)):.3e} "
                  f"greedy "
                  f"(kernels prefill, ticks; plain prefill, ticks) {toks}")

    # every K6 call of prompt 0's bf16 runs against the plain version
    seen = {"calls": 0, "y": 0.0, "differ": 0, "elems": 0, "state": 0.0}
    kernel = kops.wkv6

    def checked(r, k, v, w, u, state, *, out_state=None):
        s0 = state.clone()
        y, sT = kernel(r, k, v, w, u, state, out_state=out_state)
        y_ref, s_ref = wk.wkv6_ref(r, k, v, w, u, s0)
        yr = y_ref.float()
        d = (y.float() - yr).abs()
        seen["calls"] += 1
        seen["y"] = max(seen["y"], ((d - cs.bf16_ulp(yr)).clamp_min(0).max()
                                    / yr.abs().max()).item())
        seen["differ"] += int((d > 0).sum().item())
        seen["elems"] += d.numel()
        seen["state"] = max(seen["state"], ((sT - s_ref).abs().max()
                                            / s_ref.abs().max()).item())
        return y, sT

    kops.wkv6 = checked
    try:
        cs.prefill_and_ticks(cfg, params, prompts[:1, :args.n])
    finally:
        kops.wkv6 = kernel
    print(f"[rounding] bf16 prompt 0, {seen['calls']} K6 calls against the "
          f"plain version: y at most {seen['y']:.3e} of its largest element"
          f" off beyond one bf16 ulp, {seen['differ']} of {seen['elems']} "
          f"elements differ at all; state at most {seen['state']:.3e} of "
          f"its largest element off")
    print(cs.card_line())


if __name__ == "__main__":
    main()
