#!/usr/bin/env python3
"""The collectives of two gloo ranks sharing one card, through the card's
memory (`launch.mesh.CardExchange`) against gloo's own path (all-reduce
and broadcast on CUDA tensors, the rest staged through pinned host
buffers): every collective the mesh runs, in fp32 and bf16, at sizes from
a decode tick's activations to an FSDP gather of Ling-Lite's embedding
table, once through each path on the same operands.  Each result must be
the other path's bit for bit (two members: a + b either way); each path's
time is the median of a few calls on rank 0's host clock (the peers'
waits included), printed with the speedup and the card's name and power
limit:

    python3 scripts/torch_card_exchange.py            # ~1 min on an H100

Needs one CUDA card.
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# (label, op, elements a rank, dtype); the op's operand as the mesh passes
# it: all_reduce / broadcast / all_gather x, reduce_scatter and all_to_all
# x of 2 blocks
CASES = (
    ("tick psum 8x2048", "all_reduce", 8 * 2048, torch.bfloat16),
    ("tick psum 8x2048 fp32", "all_reduce", 8 * 2048, torch.float32),
    ("pmax 8x16", "all_reduce_max", 8 * 16, torch.float32),
    ("q gather 8x8x128", "all_gather", 8 * 8 * 128, torch.bfloat16),
    ("SP gather 1024x2048", "all_gather", 1024 * 2048, torch.bfloat16),
    ("SP scatter 2048x2048", "reduce_scatter", 2048 * 2048, torch.bfloat16),
    ("EP all-to-all 2x6144x2049", "all_to_all", 2 * 6144 * 2049,
     torch.bfloat16),
    ("FSDP gather 63232x2048", "all_gather", 63232 * 2048, torch.bfloat16),
    ("grad scatter 126464x2048 fp32", "reduce_scatter", 126464 * 2048,
     torch.float32),
    ("broadcast 1", "broadcast", 1, torch.float64),
)
REPEATS = 5


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def _call(group, op, x):
    if op == "all_reduce":
        return group.all_reduce(x)
    if op == "all_reduce_max":
        return group.all_reduce(x, op=dist.ReduceOp.MAX)
    if op == "all_gather":
        return group.all_gather(x)
    if op == "reduce_scatter":
        return group.reduce_scatter(x)
    if op == "all_to_all":
        return group.all_to_all(x.reshape(2, -1))
    return group.broadcast(x)


def _rank(rank: int, store: str, out: str):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.launch import mesh as tmesh
    torch.cuda.set_device(0)
    tmesh.init_distributed(rank, 2, init_method=f"file://{store}",
                           backend="gloo")
    card = tmesh.make_local_mesh(1, 2, device="cuda:0")
    host = tmesh.make_local_mesh(1, 2, device="cuda:0")
    for g in (host.world, host.tp_group, host.dp_group):
        g.exchange = None           # gloo's own path, for comparison
    lines = [f"[exchange] {card.describe()}", f"[exchange] {host.describe()}"]
    if card.tp_group.exchange is None:
        lines.append("[exchange] FAIL: the card exchange could not be set "
                     "up; every collective stays on gloo")
    gen = torch.Generator(device="cuda").manual_seed(rank)
    ok = True
    for label, op, n, dtype in CASES:
        x = torch.randn((n,), generator=gen, device="cuda").to(dtype)
        times = {}
        res = {}
        for name, mesh in (("card", card), ("gloo", host)):
            ts = []
            for _ in range(REPEATS):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                y = _call(mesh.tp_group, op, x)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            times[name] = statistics.median(ts)
            res[name] = y
        same = torch.equal(res["card"].view(torch.uint8),
                           res["gloo"].view(torch.uint8))
        ok &= same
        mb = n * x.element_size() / 1e6
        lines.append(
            f"[exchange] {label} ({op}, {mb:.3f} MB a rank, {dtype}): card "
            f"{1e3 * times['card']:.3f} ms, gloo {1e3 * times['gloo']:.3f} "
            f"ms ({times['gloo'] / times['card']:.1f}x), results equal bit "
            f"for bit: {same}")
    dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            f.write("\n".join(lines + [f"[exchange] ok={ok}"]) + "\n")


def main():
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this needs a CUDA card")
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.txt")
        mp.spawn(_rank, args=(os.path.join(tmp, "store"), out), nprocs=2,
                 join=True)
        text = open(out).read()
    print(text, end="")
    print(card)
    if "ok=True" not in text:
        sys.exit("the card exchange's results differ from gloo's, or it "
                 "could not be set up")


if __name__ == "__main__":
    main()
