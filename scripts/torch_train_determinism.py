#!/usr/bin/env python3
"""Run-to-run determinism of the port's training step on one card.

    python3 scripts/torch_train_determinism.py

An exact resume needs a step that gives the same bits when it is run
again on the same inputs.  For each candidate op of the step this runs
the op twice on the same inputs, at Ling-Lite's training shapes (T = 2048
tokens: seq 1024 x microbatch 2), and prints how many elements differ in
their bits:

  1. the MoE backward's scatter of dx into the tokens' rows (bf16, 6
     slots a token): `index_add_` and `index_put_(accumulate=True)`;
  2. training attention's backward (SDPA on fp32 upcasts, 16 query heads
     of 128, causal): the backend PyTorch picks, the math backend, and the
     picked one under `torch.use_deterministic_algorithms(True)`;
  3. the embedding gather's backward (the table cast to bf16, 126464 rows);
  4. the whole step: two fresh Trainers (Ling-Lite at full width cut to
     1 layer, fp32 masters from seed 0, accum 2, router warmup active)
     take 2 steps each; every parameter, moment and guard value compared.

Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def ndiff(a, b) -> int:
    """Elements of a and b whose bits differ."""
    import torch
    ints = {4: torch.int32, 2: torch.int16, 8: torch.int64}
    it = ints[a.element_size()]
    return int((a.contiguous().view(it) != b.contiguous().view(it)).sum())


def twice(fn):
    import torch
    outs = []
    for _ in range(2):
        outs.append(fn())
        torch.cuda.synchronize()
    return [ndiff(a, b) for a, b in zip(*outs)]


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_determinism: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line())
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    T, k, d = 2048, 6, 2048

    # 1. the scatter of the MoE backward's dx
    tok = torch.randperm(T * k, generator=g, device=dev) % T
    rows = torch.randn(T * k, d, generator=g, device=dev).bfloat16()
    x = torch.zeros(T, d, dtype=torch.bfloat16, device=dev)
    print("[det] dx scatter index_add_ (bf16):",
          twice(lambda: [x.clone().index_add_(0, tok, rows)]))
    print("[det] dx scatter index_put_(accumulate=True) (bf16):",
          twice(lambda: [x.clone().index_put_((tok,), rows,
                                              accumulate=True)]))

    # 2. training attention's backward
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F
    B, S, H, hd = 2, 1024, 16, 128
    q0, k0, v0 = (torch.randn(B, H, S, hd, generator=g, device=dev)
                  for _ in range(3))
    go = torch.randn(B, H, S, hd, generator=g, device=dev)

    def attn():
        q, kk, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        out = F.scaled_dot_product_attention(q, kk, v, is_causal=True)
        out.backward(go)
        return [out.detach(), q.grad, kk.grad, v.grad]
    print("[det] SDPA fp32 default backend (out, dq, dk, dv):", twice(attn))
    with sdpa_kernel(SDPBackend.MATH):
        print("[det] SDPA fp32 math backend:", twice(attn))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        print("[det] SDPA fp32 default backend, deterministic mode:",
              twice(attn))
    finally:
        torch.use_deterministic_algorithms(False)

    # 3. the embedding gather's backward
    V = 126464
    table0 = torch.randn(V, d, generator=g, device=dev) * 0.02
    ids = torch.randint(0, 4096, (T,), generator=g, device=dev)
    gy = torch.randn(T, d, generator=g, device=dev).bfloat16()

    def embed():
        table = table0.clone().requires_grad_()
        y = table.bfloat16()[ids]
        y.backward(gy)
        return [table.grad]
    print("[det] embedding backward (fp32 table):", twice(embed))

    # 4. the whole step
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.optim import adamw
    from repro_torch.training.trainer import TrainConfig, Trainer
    cfg = dataclasses.replace(get_config("ling-lite"), n_layers=1)

    def run():
        tr = Trainer(api.Runner(cfg, device=dev),
                     DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                                 seq_len=1024, batch_size=2,
                                                 seed=0)),
                     TrainConfig(n_steps=2, accum_steps=2, log_every=1,
                                 seed=0))
        try:
            tr.train()
        finally:
            tr.close()
        out = (adamw.leaves(tr.params) + adamw.leaves(tr.opt_state)
               + adamw.leaves(tr.guard_state))
        losses = [r["loss"] for r in tr.history]
        del tr
        return out, losses
    a, la = run()
    a = [t.cpu() for t in a]
    torch.cuda.empty_cache()
    b, lb = run()
    diffs = [ndiff(x_, y_.cpu()) for x_, y_ in zip(a, b)]
    print(f"[det] train step, 1 layer, 2 steps: losses {la} vs {lb}; "
          f"leaves differing {sum(1 for n in diffs if n)} of {len(diffs)}, "
          f"elements {sum(diffs)}")
    print(card_line())


if __name__ == "__main__":
    main()
