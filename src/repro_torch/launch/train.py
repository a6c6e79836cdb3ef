"""Training launcher for the port (counterpart of
`python -m repro.launch.train`).

    # on the card (default device)
    PYTHONPATH=src python -m repro_torch.launch.train --arch ling-lite \
        --steps 100 --batch 2 --seq 1024 --accum 2

    # plain PyTorch path on the CPU at smoke size
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --steps 4

    # checkpoint every 2 steps, then resume from the newest checkpoint
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --steps 4 --checkpoint-dir /tmp/ck --checkpoint-every 2
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --steps 6 --checkpoint-dir /tmp/ck --checkpoint-every 2 --resume

Builds a Runner at tp=1, the synthetic `DataPipeline`, and the `Trainer`
(AdamW + WSD schedule + accumulation or batch-size warmup + the device
spike guard, PCache checkpoints), trains from fp32 masters drawn from
`torch.Generator(device).manual_seed(0)` or resumes from the newest
checkpoint, and prints the XPUTimer span summary.  The reference's
multi-device, EDiT and trace flags are accepted and refused: those paths
are not yet ported.
"""
from __future__ import annotations

import argparse
import json

from repro_torch import api
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core import spikes as spikes_lib
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.models import model as M
from repro_torch.optim.schedule import AccumWarmup, WSDSchedule
from repro_torch.training.trainer import TrainConfig, Trainer

NOT_PORTED = ("dp", "tp", "edit_workers", "trace_out")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ling-lite")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1,
                    help="microbatches accumulated per optimizer step")
    ap.add_argument("--bs-warmup", default=None, metavar="START:END:STEPS",
                    help="batch-size warmup (§3.4.1) through the "
                         "accumulation dim: global batch grows START->END "
                         "sequences over STEPS steps while the microbatch "
                         "stays --batch; overrides --accum")
    ap.add_argument("--moe-dispatch", default="auto",
                    choices=["auto", "fused", "ragged"],
                    help="MoE dispatch: fused (K1 forward, K2 backward) or "
                         "the plain ragged composition")
    ap.add_argument("--spike-gnorm-sigma", type=float, default=None,
                    metavar="SIGMA",
                    help="also key the device spike guard on the grad norm "
                         "(§3.4.4 fn2)")
    ap.add_argument("--report", default=None, help="write history JSON here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (plain PyTorch)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest checkpoint in "
                         "--checkpoint-dir")
    # the reference's flags for paths that are not yet ported
    ap.add_argument("--dp", type=int, default=None)
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--edit-workers", type=int, default=None)
    ap.add_argument("--trace-out", default=None)
    args = ap.parse_args(argv)

    for name in NOT_PORTED:
        v = getattr(args, name)
        if v and not (name in ("dp", "tp") and v == 1):
            ap.error(f"--{name.replace('_', '-')} is not yet ported to "
                     f"repro_torch (tp=1, one device, no EDiT, no trace)")
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume needs --checkpoint-dir")
    bs_warmup = None
    if args.bs_warmup:
        try:
            start, end, steps = (int(x) for x in args.bs_warmup.split(":"))
            bs_warmup = AccumWarmup(microbatch=args.batch, start=start,
                                    end=end, warmup_steps=steps)
        except ValueError as e:
            ap.error(f"--bs-warmup: {e}")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    runner = api.Runner(cfg, flags=M.RunFlags(moe_dispatch=args.moe_dispatch),
                        device=args.device)
    pipe = DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                       seq_len=args.seq,
                                       batch_size=args.batch))
    tcfg = TrainConfig(
        n_steps=args.steps,
        lr_schedule=WSDSchedule(max_lr=args.lr, warmup_steps=20,
                                total_steps=max(args.steps, 1)),
        spike=spikes_lib.SpikeConfig(
            gnorm_sigma_threshold=args.spike_gnorm_sigma),
        accum_steps=args.accum, bs_warmup=bs_warmup,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every)
    trainer = Trainer(runner, pipe, tcfg)
    try:
        if args.resume:
            name = trainer.restore("latest")
            print(f"[train] resumed from {name} at step {trainer.step}")
        history = trainer.train()
    finally:
        trainer.close()
    print(json.dumps(trainer.timer.diagnose()["spans"], indent=1))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(history, f, indent=1)
    if history:
        print(f"final loss: {history[-1]['loss']:.4f}")
    else:
        print("final loss: n/a (no steps ran)")


if __name__ == "__main__":
    main()
