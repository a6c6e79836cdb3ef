#!/usr/bin/env python3
"""Whether full-width Ling-Lite's paged serving steps give a row the same
bits whatever the other rows of the call, on one card: speculative
decoding's verify pass (B*(k+1) rows) must give each row the logits of
the decode tick (B rows) it stands for, and a preempted request's replay
rewrites decoded rows through a prefill chunk (64 rows).

    python3 scripts/torch_ling_rounding.py [--k 4] [--src DIR]

The weights are chip_smoke.py phase 5's (seed 0, serving storage).  It
prints, in order:

  * each op of the paged block on 64 random rows of layer 0, given 40
    and 64 rows at a time (a verify pass at k = 4, a prefill chunk)
    against the same rows given 8 at a time (a decode tick at 8 slots):
    the elements that differ;
  * the paged attention (K3 + K4 and the normalization) at the verify
    shape (8 slots x 5 queries) and at a prefill chunk's (1 x 64 rows)
    against the same queries one position at a time: the elements that
    differ;
  * end to end, 8 slots prefilled with 64-token prompts (numpy seed 0),
    then k+1 teacher-forced decode ticks against one verify pass over
    the same tokens from the same pools, and against one prefill chunk
    per slot: the logit rows that differ, the largest difference as a
    share of the largest logit, the greedy tokens that differ, and the
    KV elements (all layers) that the prefill writes other than the
    ticks;
  * times (CUDA events, median of 20): a decode tick, the verify pass,
    the draft proposal of a 4-layer self-draft, and one sampling call
    (`sharded_sample`) at 8 and at 40 rows of the 126464-wide vocab.

`--src` runs the port found in DIR (for instance an unpacked parent
commit's `src`).  Needs a CUDA card; prints the card's name and power
limit first and last.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TICK_ROWS = 8          # a decode tick's rows at chip_smoke's 8 slots


def by_ticks(f, x):
    """f over x (N, d) in calls of TICK_ROWS rows, concatenated."""
    import torch
    return torch.cat([f(x[i:i + TICK_ROWS])
                      for i in range(0, x.shape[0], TICK_ROWS)])


def op_rows(cfg, params):
    """{op: (differ at 40 rows, differ at 64 rows, elements at 64)}."""
    import torch
    from repro_torch.core import moe as moe_lib
    from repro_torch.core import router as router_lib
    from repro_torch.models import embedding as emb
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    lp = M.layer_params(params["blocks"], 0)
    at, mo = lp["attn"], lp["moe"]
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((64, cfg.d_model), generator=g, device="cuda").bfloat16()
    xo = torch.randn((64, at["wo"].shape[0]), generator=g,
                     device="cuda").bfloat16()       # the attention's heads
    ops = {
        "rms norm": lambda v: L.apply_norm(cfg, lp["norm1"], v),
        "q projection (bf16 cuBLAS)": lambda v: v @ at["wq"],
        "k projection": lambda v: v @ at["wk"],
        "v projection": lambda v: v @ at["wv"],
        "o projection": lambda v: v @ at["wo"],       # on xo
        "router logits in fp32 (cuBLAS; the parent's serving router)":
            lambda v: v.float() @ mo["router"]["wr"].float(),
        "router gates and experts (serving: fp64 logits rounded once)":
            lambda v: torch.cat([t.float() for t in router_lib.route(
                cfg, mo["router"], v)], 1),
        "shared expert (three bf16 cuBLAS products)":
            lambda v: L.apply_mlp(cfg, mo["shared"], v),
        "MoE FFN (router, K1, shared expert)":
            lambda v: moe_lib.moe_ffn(cfg, mo, v)[0],
        "NormHead logits (K5)":
            lambda v: emb.serve_logits(cfg, params["embed"], v),
    }
    out = {}
    with torch.no_grad():
        for name, f in ops.items():
            v = xo if name == "o projection" else x
            ref = by_ticks(f, v)
            d40 = int((f(v[:40]) != ref[:40]).sum())
            d64 = int((f(v) != ref).sum())
            out[name] = (d40, d64, ref.numel())
    return out


def attention_rows(cfg):
    """K3 + K4 at the verify and prefill shapes against one query
    position at a time: {shape: (elements that differ, elements)}."""
    import torch
    from repro_torch.models import layers as L
    g = torch.Generator(device="cuda").manual_seed(4)
    ad = L.AttnDims.build(cfg)
    ps, n_lp, n_pages = 16, 32, 8 * 32 + 1
    cdt = torch.bfloat16
    shp = (n_pages, ps, cfg.n_kv_heads, cfg.head_dim)
    pool = {"k": torch.randn(shp, generator=g, device="cuda").to(cdt),
            "v": torch.randn(shp, generator=g, device="cuda").to(cdt)}
    out = {}
    for label, B, Q, ctx in (("verify 8 x 5", 8, 5,
                              [100, 300, 37, 171, 256, 64, 129, 233]),
                             ("prefill 1 x 64", 1, 64, [192])):
        table = torch.zeros((B, n_lp), dtype=torch.int32, device="cuda")
        perm = torch.randperm(n_pages - 1, generator=g, device="cuda") + 1
        used = 0
        for b, c in enumerate(ctx):
            n = -(-c // ps)
            table[b, :n] = perm[used:used + n].to(torch.int32)
            used += n
        pos = torch.tensor([[c - Q + j for j in range(Q)] for c in ctx],
                           device="cuda")
        valid = L.paged_valid_mask(table, pos, page_size=ps)
        q = torch.randn((B, Q, cfg.n_heads, cfg.head_dim), generator=g,
                        device="cuda").to(cdt)
        core = lambda qq, vv: L._paged_attention_core(
            cfg, ad, qq, pool, table, vv, cdt, paged_attn="fused")
        with torch.no_grad():
            whole = core(q, valid)
            one = torch.cat([core(q[:, j:j + 1].contiguous(),
                                  valid[:, j:j + 1]) for j in range(Q)], 1)
        out[label] = (int((whole != one).sum()), whole.numel())
    return out


def recorded(run):
    """Run `run()` with the paged block's ops recording their outputs:
    [(op, tensor)] in call order."""
    from repro_torch.core import moe as moe_lib
    from repro_torch.core import router as router_lib
    from repro_torch.models import embedding as emb
    from repro_torch.models import layers as L
    rec = []
    spots = [(L, "apply_norm"), (L, "_qkv"), (L, "_paged_attention_core"),
             (L, "paged_decode_attention"), (L, "paged_verify_attention"),
             (moe_lib, "moe_ffn"), (router_lib, "route"), (L, "apply_mlp"),
             (emb, "serve_logits")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in spots]

    def wrap(mod, name, fn):
        def f(*a, **kw):
            out = fn(*a, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            label = ("attention out" if name.startswith("paged_")
                     else name)
            for i, t in enumerate(outs):
                if isinstance(t, __import__("torch").Tensor):
                    rec.append((f"{label}[{i}]", t.clone()))
            return out
        setattr(mod, name, f)

    for mod, name, fn in saved:
        wrap(mod, name, fn)
    try:
        run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return rec


def first_parting(tick_recs, ver_rec, B, Q, n=12):
    """Compare the verify pass's recorded ops with the ticks', call by
    call (the ticks' rows stacked by position): the first `n` that part,
    as (call index, op, elements that differ, elements)."""
    import torch
    out = []
    for i, (name, v) in enumerate(ver_rec):
        ts = [rec[i][1] for rec in tick_recs]
        if ts[0].dim() == 4 and ts[0].shape[1] == 1:        # (B, 1, H, hd)
            t = torch.cat(ts, 1)
            v = v.reshape(t.shape)
        elif ts[0].shape[0] == B:
            t = torch.stack(ts, 1)
            v = v.reshape(t.shape)
        else:
            continue
        d = int((t != v).sum())
        if d:
            out.append((i, name, d, t.numel()))
            if len(out) >= n:
                break
    return out


def end_to_end(cfg, params, k: int):
    import numpy as np
    import torch
    from repro_torch.models import model as M
    B, P, ps, C = 8, 64, 16, 64
    npp = -(-(P + C) // ps)
    rs = np.random.RandomState(0)
    prompts = torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, P))).to("cuda")
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                       (B, k + 1))).to("cuda")
    table = (1 + torch.arange(B * npp, device="cuda",
                              dtype=torch.int32)).reshape(B, npp)
    active = torch.ones((B,), dtype=torch.bool, device="cuda")
    pools = M.init_paged_caches(cfg, 1 + B * npp, ps, "cuda")
    clone = lambda pl: {"self": {n: t.clone() for n, t in pl["self"].items()}}
    with torch.no_grad():
        for b in range(B):
            M._paged_prefill_logits(cfg, params, pools, prompts[b], 0, P,
                                    table[b], page_size=ps)
        start = clone(pools)
        ticks, tick_recs = [], []
        for j in range(k + 1):
            got = []
            tick_recs.append(recorded(lambda: got.append(
                M._paged_decode_logits(
                    cfg, params, pools, toks[:, j],
                    torch.full((B,), P + j, device="cuda"), table, active,
                    page_size=ps)[0])))
            ticks.append(got[0])
        ticks = torch.stack(ticks, 1).reshape(B * (k + 1), -1)
        vpools = clone(start)
        pos = P + torch.arange(k + 1, device="cuda")[None].expand(B, -1)
        got = []
        ver_rec = recorded(lambda: got.append(M._paged_verify_logits(
            cfg, params, vpools, toks, pos, table, active,
            page_size=ps)[0]))
        ver = got[0]
        for i, name, d, n in first_parting(tick_recs, ver_rec, B, k + 1):
            print(f"[rounding] verify vs ticks, call {i} ({name}, layer "
                  f"{i // max(1, len(ver_rec) // cfg.n_layers)}): {d} of {n} "
                  f"elements differ")
        ppools = clone(start)
        last = []
        for b in range(B):
            chunk = torch.zeros((C,), dtype=toks.dtype, device="cuda")
            chunk[:k + 1] = toks[b]
            lg, _ = M._paged_prefill_logits(cfg, params, ppools, chunk, P,
                                            k + 1, table[b], page_size=ps)
            last.append(lg[0])
    top = ticks.abs().max().item()
    rows = lambda a, b: int((a != b).any(-1).sum())
    tick_last = ticks.reshape(B, k + 1, -1)[:, -1]
    pre = torch.stack(last)
    kv = 0
    kv_n = 0
    for n in ("k", "v"):
        for b in range(B):
            for j in range(k + 1):
                p = P + j
                page = table[b, p // ps].long()
                a = pools["self"][n][:, page, p % ps]
                c = ppools["self"][n][:, page, p % ps]
                kv += int((a != c).sum())
                kv_n += a.numel()
    print(f"[rounding] end to end, {B} slots x {k + 1} positions: verify "
          f"pass vs decode ticks: {rows(ver, ticks)} of {B * (k + 1)} logit "
          f"rows differ, largest difference "
          f"{(ver - ticks).abs().max().item() / top:.3e} of the largest "
          f"logit, greedy tokens differ in "
          f"{int((ver.argmax(-1) != ticks.argmax(-1)).sum())}")
    print(f"[rounding] end to end, a prefill chunk of the {k + 1} tokens per "
          f"slot vs the ticks: {kv} of {kv_n} KV elements (all layers) "
          f"differ; last-position logits: {rows(pre, tick_last)} of {B} rows "
          f"differ, largest difference "
          f"{(pre - tick_last).abs().max().item() / top:.3e} of the "
          f"largest logit, greedy tokens differ in "
          f"{int((pre.argmax(-1) != tick_last.argmax(-1)).sum())}")
    return prompts, toks, table, start


def times(cfg, params, k, table, start):
    import torch
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.models import embedding as emb
    from repro_torch.serving.draft import SelfDrafter
    B, P = 8, 64
    runner = api.Runner(cfg, device="cuda")
    dec = runner.make_paged_decode_step(16, sample=True)
    ver = runner.make_paged_verify_step(16, k)
    drunner, dparams = SelfDrafter(min(4, cfg.n_layers)).build(runner, params)
    dra = drunner.make_paged_draft_propose(16, k)
    dpools = drunner.init_paged_pools(start["self"]["k"].shape[1], 16)
    active = torch.ones((B,), dtype=torch.bool, device="cuda")
    knobs = (torch.arange(B, device="cuda"),
             torch.full((B,), 0.8, device="cuda"),
             torch.full((B,), 0.95, device="cuda"),
             torch.full((B,), 64, device="cuda"))
    tok = torch.zeros((B,), dtype=torch.long, device="cuda")
    pos = torch.full((B,), P, device="cuda")
    tokens = torch.zeros((B, k + 1), dtype=torch.long, device="cuda")
    dprobs = torch.full((B, k, cfg.vocab_size), 1.0 / cfg.vocab_size,
                        device="cuda")
    t_dec = cs.cuda_ms(lambda: dec(params, start, tok, pos, table, active,
                                   *knobs), iters=10)
    t_ver = cs.cuda_ms(lambda: ver(params, start, tokens, pos, table, active,
                                   dprobs, *knobs), iters=10)
    t_dra = cs.cuda_ms(lambda: dra(dparams, dpools, tok, pos, table, active,
                                   *knobs), iters=10)
    g = torch.Generator(device="cuda").manual_seed(5)
    out = []
    for T in (8, 40):
        lg = torch.randn((T, cfg.vocab_size), generator=g, device="cuda")
        kn = tuple(torch.repeat_interleave(a, T // B) for a in knobs)
        out.append(cs.cuda_ms(lambda: emb.sharded_sample(
            cfg, lg, seeds=kn[0], pos=kn[0], temperature=kn[1],
            top_p=kn[2], top_k=kn[3])))
    print(f"[rounding] times: sampled decode tick {t_dec:.2f}ms, verify step "
          f"(k={k}) {t_ver:.2f}ms, draft proposal (4-layer self-draft, k={k})"
          f" {t_dra:.2f}ms; one sampling call at 8 x {cfg.vocab_size} "
          f"{out[0]:.3f}ms, at 40 x {cfg.vocab_size} {out[1]:.3f}ms")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    print(cs.card_line())
    print(f"[rounding] port from {M.__file__}")
    cfg = get_config("ling-lite")
    params = api.Runner(cfg, device="cuda").init_params(0)
    for op, (d40, d64, n) in op_rows(cfg, params).items():
        print(f"[rounding] {op}: {d40} (40 rows) / {d64} (64 rows) of {n} "
              f"elements differ from the same rows {TICK_ROWS} at a time")
    for label, (d, n) in attention_rows(cfg).items():
        print(f"[rounding] paged attention (K3 + K4) {label}: {d} of {n} "
              f"elements differ from one query position at a time")
    _, _, table, start = end_to_end(cfg, params, args.k)
    times(cfg, params, args.k, table, start)
    print(cs.card_line())


if __name__ == "__main__":
    main()
