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

    # EDiT local SGD: 2 workers, a sync every 4 local steps
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --steps 8 --edit-workers 2

    # the other block families: LayerNorm, sliding windows, RG-LRU
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --arch recurrentgemma-2b --steps 4 --batch 2 --seq 32

    # a (dp=2, tp=2) mesh of 4 gloo ranks on the CPU (Ling-Lite only)
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --dp 2 --tp 2 --steps 2

    # 2 ranks on the card(s): NCCL with a card per rank, gloo when they
    # share one; or one process per rank under torchrun
    PYTHONPATH=src python -m repro_torch.launch.train --dp 2 --steps 4 \
        --batch 2 --seq 1024
    PYTHONPATH=src torchrun --nproc-per-node 2 -m \
        repro_torch.launch.train --tp 2 --steps 4 --batch 2 --seq 1024

Builds a Runner, the synthetic `DataPipeline`, and the `Trainer`
(AdamW + WSD schedule + accumulation or batch-size warmup + the device
spike guard, PCache checkpoints), trains from fp32 masters drawn from
`torch.Generator(device).manual_seed(0)` or resumes from the newest
checkpoint, and prints the XPUTimer span summary; `--trace-out` writes
the run's Chrome trace (the trainer's spans and the registry's series).
`--edit-workers K` runs EDiT instead (`core.edit.EDiTTrainer`, as the
reference's launcher: K workers one after the other on the device,
`sync_every` 4, `max(1, steps // 4)` rounds, a constant `--lr`) and
prints each round's record.  `--dp` / `--tp` train on a (dp, tp) mesh,
one process per rank (`launch.mesh.run_ranks`: torchrun's environment
where it is set, else spawned ranks), every rank over the same seeded
pipeline, rank 0 printing; EDiT and checkpoints are refused there
(ROADMAP item 9).  An encoder-decoder (whisper-tiny) is refused: the
synthetic pipeline feeds no encoder frames, so it trains through
`api.Runner` alone.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import api
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core import spikes as spikes_lib
from repro_torch.core.edit import EDiTConfig, EDiTTrainer
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import model as M
from repro_torch.models import prng
from repro_torch.optim import adamw
from repro_torch.optim.schedule import AccumWarmup, WSDSchedule
from repro_torch.telemetry import write_chrome_trace
from repro_torch.training.trainer import TrainConfig, Trainer


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
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--moe-dispatch", default="auto",
                    choices=["auto", "fused", "ragged", "ep"],
                    help="MoE dispatch: fused (K1 forward, K2 backward) or "
                         "the plain ragged composition at tp=1; 'ep' (the "
                         "expert-parallel all-to-all, K1 and K2 on each "
                         "shard) at tp > 1")
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
    ap.add_argument("--edit-workers", type=int, default=0,
                    help=">0 runs EDiT local-SGD with K workers")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON of the run "
                         "(XPUTimer spans + registry series), viewable at "
                         "https://ui.perfetto.dev")
    args = ap.parse_args(argv)

    if args.dp < 1 or args.tp < 1:
        ap.error("--dp and --tp take sizes >= 1")
    if args.dp * args.tp > 1 and (args.edit_workers > 0
                                  or args.checkpoint_dir):
        ap.error("EDiT's pod axis and sharded checkpoints on a mesh are not "
                 "yet ported (ROADMAP item 9)")
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume needs --checkpoint-dir")
    bs_warmup = None
    if args.bs_warmup:
        if args.edit_workers > 0:
            ap.error("--bs-warmup is not supported with --edit-workers")
        try:
            start, end, steps = (int(x) for x in args.bs_warmup.split(":"))
            bs_warmup = AccumWarmup(microbatch=args.batch, start=start,
                                    end=end, warmup_steps=steps)
        except ValueError as e:
            ap.error(f"--bs-warmup: {e}")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encoder_decoder:
        ap.error(f"{args.arch} is an encoder-decoder: the launcher's data "
                 f"pipeline feeds no encoder frames (as the reference's); "
                 f"train it through api.Runner.make_train_step with "
                 f"batch['enc_frames']")
    if args.dp * args.tp > 1 and cfg.arch_id not in M.MESH_ARCHS:
        ap.error(f"{args.arch} on a (dp={args.dp}, tp={args.tp}) mesh is "
                 f"not yet ported (ROADMAP item 9)")
    run_ranks(train_rank, args.dp, args.tp, args.device, args, cfg,
              bs_warmup)


def train_rank(mesh, args, cfg, bs_warmup):
    """One rank's run (the whole run at (1, 1)): the Runner on `mesh`, the
    pipeline, the Trainer or EDiT, the report and the final loss."""
    runner = api.Runner(cfg, flags=M.RunFlags(moe_dispatch=args.moe_dispatch),
                        device=mesh.device if mesh.size > 1 else args.device,
                        mesh=mesh)
    if mesh.size > 1:
        print(f"[train] {mesh.describe()}")
    pipe = DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                       seq_len=args.seq,
                                       batch_size=args.batch))
    spike_cfg = spikes_lib.SpikeConfig(
        gnorm_sigma_threshold=args.spike_gnorm_sigma)
    if args.edit_workers > 0:
        history = run_edit(args, runner, pipe, spike_cfg)
    else:
        history = run_trainer(args, runner, pipe, spike_cfg, bs_warmup)
    if args.report and mesh.rank == 0:
        with open(args.report, "w") as f:
            json.dump(history, f, indent=1)
    if history:
        last = history[-1]
        print(f"final loss: "
              f"{last.get('loss', last.get('mean_loss', float('nan'))):.4f}")
    else:
        print("final loss: n/a (no steps ran)")


def edit_worker_step(runner, spike_cfg):
    """An EDiT worker's step on the runner's train step (spike-guarded,
    accumulation-aware): ``(params, opt, host batch, i, lr) -> (params,
    opt, loss)``, the opt slot carrying (AdamW state, device guard
    state); step i draws under the threefry key of i, as the reference's
    `jax.random.PRNGKey(i)`."""
    dev = runner.device
    step = runner.make_train_step(spike_guard=spike_cfg)

    def worker_step(w, opt, batch, i, lr):
        if opt is None:
            opt = (adamw.init_opt_state(w),
                   spikes_lib.init_guard_state(spike_cfg, dev))
        o, g = opt
        tb = {k: torch.from_numpy(v).long().to(dev) for k, v in batch.items()}
        w, o, g, m = step(w, o, g, tb, i, prng.prng_key(i, dev), lr)
        return w, (o, g), m["loss"]
    return worker_step


def run_edit(args, runner, pipe, spike_cfg):
    """EDiT from `init_train_params(0)`: `max(1, steps // 4)` rounds of 4
    local steps a worker, 4 fresh macrobatches a worker a round."""
    edit = EDiTTrainer(runner.init_train_params(0),
                       edit_worker_step(runner, spike_cfg),
                       EDiTConfig(sync_every=4), args.edit_workers)
    for r in range(max(1, args.steps // 4)):
        batches = [[pipe.next_macrobatch(args.accum) for _ in range(4)]
                   for _ in range(args.edit_workers)]
        rec = edit.round(batches, lr=args.lr)
        print(f"[edit] round={r} {rec}")
    return edit.history


def run_trainer(args, runner, pipe, spike_cfg, bs_warmup):
    """The Trainer path; prints the XPUTimer span summary and writes the
    Chrome trace when asked."""
    tcfg = TrainConfig(
        n_steps=args.steps,
        lr_schedule=WSDSchedule(max_lr=args.lr, warmup_steps=20,
                                total_steps=max(args.steps, 1)),
        spike=spike_cfg,
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
    if args.trace_out:
        n = write_chrome_trace(args.trace_out, timer=trainer.timer,
                               registry=trainer.registry)
        print(f"[train] trace ({n} events) -> {args.trace_out} "
              f"(open at https://ui.perfetto.dev)")
    return history


if __name__ == "__main__":
    main()
