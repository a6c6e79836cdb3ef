#!/usr/bin/env python3
"""Phase 8b of `chip_smoke.py` alone (checkpoint and exact resume of
Ling-Lite at full width cut to 1 layer on one card), from the checkout
at --root: its `[resume]` lines give each save's fetch and background
write GB/s and each restore's GB/s.  It runs the checkout's own `src/`
and `chip_smoke.py`, so two checkouts compare on the same card in one
call (parent, change, change, parent):

    python3 scripts/torch_ckpt_rates.py --root PARENT_DIR
    python3 scripts/torch_ckpt_rates.py

Needs a CUDA card, `nvcc` and ~28 GB free under the temporary directory
(two 13.09 GB checkpoints, removed after).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout to run (default: this one)")
    root = Path(ap.parse_args().root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from repro_torch.kernels import build
    card = chip_smoke.card_line()
    t0 = time.perf_counter()
    build.build_all()
    print(f"[rates] {root}: built in {time.perf_counter() - t0:.1f}s "
          f"[{card}]", flush=True)
    t0 = time.perf_counter()
    chip_smoke.train_resume(card)
    print(f"[rates] {root}: phase 8b took {time.perf_counter() - t0:.1f}s "
          f"[{card}]", flush=True)


if __name__ == "__main__":
    main()
