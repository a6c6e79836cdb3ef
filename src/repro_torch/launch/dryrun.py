"""Dry run of the port (counterpart of `repro.launch.dryrun`).

Traces one rank's program of an (architecture x input shape) pair on
PyTorch's `meta` device at a production (dp, tp) mesh: the path the card
runs, the hand-written kernels included (each wrapper's `meta` branch),
with every collective on `launch.mesh.Mesh.dry`'s groups.  It allocates
nothing and needs neither a card nor a process group.  It records, for
that one device: FLOPs by dtype, HBM bytes and collective bytes (each
collective's calls and operand bytes, as the mesh's `stats` count a real
run's), the memory (the step's arguments, its gradients, the peak of
what it allocates, and whether argument + peak fit the card's 80 GB),
every kernel's launches and cost, and the three-term roofline on the
H100's constants (`roofline`).

    python -m repro_torch.launch.dryrun --arch ling-plus --shape train_4k
    python -m repro_torch.launch.dryrun --arch ling-lite --shape all --multi-pod
    python -m repro_torch.launch.dryrun --arch all [--dp 32 --tp 8] [--out DIR]

The pairs, as the reference lowers them:
  * train: `make_train_step` on fp32 masters with AdamW state, the global
    batch of the shape (the rank keeps its dp rows);
  * prefill: `make_prefill` on bf16 serving parameters, whole on each
    dp rank (the reference lowers its prefill with `fsdp=False`);
  * decode: one `make_decode_step` tick over dense caches of `seq_len`
    positions, at the last position, on bf16 serving parameters whole
    on each dp rank, or FSDP over dp with `--serve-fsdp`;
  * long_500k only where `supported_shapes` allows it.

Meshes: (16, 16) by default; `--multi-pod` (32, 16), the reference's
2 x 16 x 16 with its `pod` axis, a data axis, folded into dp; `--dp` /
`--tp` any other.  Ranks are laid out tp fastest, 8 to a node, so a tp
group of up to 8 talks over NVLink and a wider group over InfiniBand
(`roofline.link_bytes_s`).  The record's `param_storage` says how the
pair's parameters were stored.  The reference's `--schedule`,
`--attn-block` and `--no-gather-cast` have no counterpart (the port's
intended departures) and raise.

`chip_smoke.py` holds these same functions (`Step`, `step_args`,
`count_step`, `trace`) against the card's runs of the train step and the
dense serving steps.

One JSON per pair goes under `--out` (default experiments/dryrun_torch)
and one line per pair to standard output.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch import api, roofline
from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, ModelConfig,
                                      ShapeConfig, get_config,
                                      supported_shapes)
from repro_torch.core import spikes as spikes_lib
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import prng
from repro_torch.optim import adamw

ASSIGNED = [a for a in ARCH_IDS if a not in ("ling-lite", "ling-plus")]

SINGLE_POD, MULTI_POD = (16, 16), (32, 16)

# the reference's flags the port has no counterpart of
DEPARTURES = {
    "schedule": "training attention is SDPA's math backend on fp32 upcasts "
                "with an explicit causal or window mask: there is no "
                "blockwise schedule to pick (intended departure)",
    "attn_block": "training attention is SDPA's math backend, which picks "
                  "its own tiles: there is no attn_block (intended "
                  "departure)",
    "no_gather_cast": "FSDP gathers always cast the masters to the compute "
                      "dtype before the gather (intended departure)",
}

TRAIN_STEP = 1              # the step index the traced train step takes


@dataclasses.dataclass(frozen=True)
class Step:
    """What a traced step runs beyond its shape: the train step's
    microbatches (the batch is (accum, B, S) when accum > 1), AdamW
    settings, spike guard and step index; the serving steps' cache
    length (default the shape's seq_len) and the decode tick's position
    (default the caches' last)."""
    accum: int = 1
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    spike: Optional[spikes_lib.SpikeConfig] = None
    index: int = TRAIN_STEP
    cache_len: Optional[int] = None
    pos: Optional[int] = None


def mesh_name(dp: int, tp: int) -> str:
    return f"{dp}x{tp}"


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under `tensors` (a cache's views of
    padded storage count the storage)."""
    seen: Dict[int, int] = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _tree(tree):
    return [t for t in adamw.leaves(tree) if isinstance(t, torch.Tensor)]


def step_args(runner: api.Runner, shape: ShapeConfig, st: Step = Step(), *,
              params=None, opt_state=None, guard=None) -> Dict[str, Any]:
    """The arguments of one step of `shape` (its mode, global batch and
    seq_len) on the runner's device: `meta` tensors when the runner works
    there, zeros otherwise; `params`, `opt_state` and `guard` where
    given, else built on the runner's device (fp32 masters for
    training, AdamW's moments, the spike guard's state)."""
    cfg, dev = runner.cfg, runner.device
    mode, B, S = shape.mode, shape.global_batch, shape.seq_len
    if params is None:
        params = M.init_model(cfg, device=dev, masters=mode == "train",
                              max_seq=runner.max_seq, env=runner.env)
    cdt = L.dtype_of(cfg.compute_dtype)
    lead = (st.accum,) if mode == "train" and st.accum > 1 else ()
    batch = {"tokens": torch.zeros(lead + (B, S), dtype=torch.long,
                                   device=dev)}
    if cfg.is_encoder_decoder:
        batch["enc_frames"] = torch.zeros(
            lead + (B, cfg.encoder_seq_len, cfg.d_model), dtype=cdt,
            device=dev)
    if mode == "train":
        batch["labels"] = torch.zeros(lead + (B, S), dtype=torch.long,
                                      device=dev)
        if opt_state is None:
            opt_state = adamw.init_opt_state(params)
        if guard is None and st.spike is not None:
            guard = spikes_lib.init_guard_state(st.spike, dev)
        return {"params": params, "opt": opt_state, "guard": guard,
                "batch": batch}
    if mode == "prefill":
        return {"params": params, "batch": batch}
    n = st.cache_len or S
    return {"params": params, "caches": runner.init_caches(B, n),
            "token": torch.zeros((B,), dtype=torch.long, device=dev),
            "pos": n - 1 if st.pos is None else st.pos}


def run_step(runner: api.Runner, shape: ShapeConfig, st: Step,
             args: Dict[str, Any]):
    """One step of `shape`'s mode on `args` (`step_args`' layout)."""
    if shape.mode == "train":
        step = runner.make_train_step(st.opt, spike_guard=st.spike)
        rng = prng.prng_key(st.index, device=runner.device)
        return step(args["params"], args["opt"], args["guard"],
                    args["batch"], st.index, rng, 1e-4)
    if shape.mode == "prefill":
        return runner.make_prefill(seq_len=st.cache_len)(args["params"],
                                                          args["batch"])
    return runner.make_decode_step()(args["params"], args["caches"],
                                     args["token"], args["pos"])


def argument_bytes(mode: str, args: Dict[str, Any]) -> int:
    """The step's arguments: parameters, and the optimizer state, the
    spike guard's state and the batch (train), the batch (prefill), or
    the caches and tokens (decode)."""
    ts = _tree(args["params"])
    if mode == "train":
        ts += (_tree(args["opt"]) + _tree(args["guard"] or {})
               + list(args["batch"].values()))
    elif mode == "prefill":
        ts += list(args["batch"].values())
    else:
        ts += _tree(args["caches"]) + [args["token"]]
    return _storage_bytes(ts)


def gradient_bytes(mode: str, args: Dict[str, Any]) -> int:
    """The fp32 gradients a train step makes of the parameters."""
    if mode != "train":
        return 0
    return sum(t.numel() * 4 for t in _tree(args["params"]))


def count_step(runner: api.Runner, shape: ShapeConfig, st: Step,
               args: Dict[str, Any]):
    """Runs one step under a `roofline.counter()`: (the counter, the
    mesh's collective stats of the step)."""
    mesh = runner.env.mesh
    mesh.stats.clear()
    for g in (mesh.world, mesh.tp_group, mesh.dp_group):
        g.own.clear()
    with roofline.counter() as c:
        run_step(runner, shape, st, args)
    return c, {op: {"calls": s["calls"], "bytes": s["bytes"]}
               for op, s in mesh.stats.items()}


def param_fsdp(mode: str, serve_fsdp: bool) -> bool:
    """Whether a pair's parameters are FSDP over dp, as the reference
    lowers it: always in training, never in prefill, and in decode with
    `--serve-fsdp`."""
    return mode == "train" or (mode == "decode" and serve_fsdp)


def trace(cfg: ModelConfig, shape: ShapeConfig, dp: int, tp: int,
          rank: int = 0, flags: M.RunFlags = M.DEFAULT_FLAGS,
          st: Step = Step(), *, sp_comm: str = "native",
          serve_fsdp: bool = False) -> Dict[str, Any]:
    """The dry run of one rank of a (dp, tp) mesh for `shape` (its global
    batch and sequence length) and `st`: the record's counts, memory and
    roofline (without the pair's names)."""
    mesh = Mesh.dry(dp, tp, rank)
    runner = api.Runner(cfg, flags=flags, device="meta",
                        max_seq=st.cache_len or shape.seq_len, mesh=mesh,
                        sp_comm=sp_comm,
                        fsdp=param_fsdp(shape.mode, serve_fsdp))
    mode = shape.mode
    t0, c0 = time.perf_counter(), time.process_time()
    args = step_args(runner, shape, st)
    arg_bytes = argument_bytes(mode, args)
    grad_bytes = gradient_bytes(mode, args)
    c, stats = count_step(runner, shape, st, args)
    axes = {}
    for axis, g in (("world", mesh.world), ("tp", mesh.tp_group),
                    ("dp", mesh.dp_group)):
        if g.size > 1 and g.own:
            axes[axis] = (g.size, roofline.link_bytes_s(g.ranks),
                          {op: dict(s) for op, s in g.own.items()})
    rl = roofline.roofline(
        c.flops, c.bytes, axes,
        model_flops=roofline.model_flops_per_chip(cfg, shape, dp * tp))
    peak = arg_bytes + c.peak
    return {
        "memory": {"argument_bytes": arg_bytes, "gradient_bytes": grad_bytes,
                   "peak_live_bytes": c.peak, "peak_bytes": peak,
                   "device_bytes": roofline.HBM_BYTES,
                   "fits": peak <= roofline.HBM_BYTES},
        "roofline": rl.to_dict(),
        "kernels": c.kernels,
        "collective_stats": stats,
        "trace_s": time.perf_counter() - t0,
        "cpu_s": time.process_time() - c0,
    }


def run_pair(arch: str, shape_name: str, dp: int, tp: int,
             flags: M.RunFlags = M.DEFAULT_FLAGS, *, rank: int = 0,
             sp_comm: str = "native", cf: Optional[float] = None,
             serve_fsdp: bool = False) -> Dict[str, Any]:
    """One (arch, shape) pair at rank `rank` of a (dp, tp) mesh: the
    reference's record keys (arch, shape, mesh, status, memory, roofline,
    flags, params_total, params_active) and the port's (rank,
    param_storage, kernels, collective_stats, trace_s, cpu_s)."""
    cfg = get_config(arch)
    if cf is not None and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_name(dp, tp),
            "rank": rank}
    if shape_name not in supported_shapes(cfg):
        return {**head, "status": "skipped",
                "reason": "long_500k requires sub-quadratic attention "
                          "(full-attention architecture)"}
    shape = INPUT_SHAPES[shape_name]
    rec = trace(cfg, shape, dp, tp, rank, flags, sp_comm=sp_comm,
                serve_fsdp=serve_fsdp)
    fsdp = param_fsdp(shape.mode, serve_fsdp) and dp > 1
    return {**head, "status": "ok", **rec,
            "param_storage": ("fsdp over dp" if fsdp
                              else "whole on each dp rank"),
            "flags": {**dataclasses.asdict(flags), "sp_comm": sp_comm,
                      "cf": cf, "serve_fsdp": serve_fsdp},
            "params_total": cfg.param_count(),
            "params_active": cfg.active_param_count()}


def _line(tag: str, rec: Dict[str, Any]) -> str:
    extra = ""
    if rec["status"] == "ok":
        r, m = rec["roofline"], rec["memory"]
        extra = (f" bottleneck={r['bottleneck']}"
                 f" compute={roofline.fmt_seconds(r['compute_s'])}"
                 f" mem={roofline.fmt_seconds(r['memory_s'])}"
                 f" coll={roofline.fmt_seconds(r['collective_s'])}"
                 f" useful={r['useful_ratio']:.2f}"
                 f" peak={m['peak_bytes'] / 1e9:.1f}GB"
                 f"{'' if m['fits'] else ' (over 80 GB)'}"
                 f" trace={rec['trace_s']:.1f}s")
    elif rec["status"] == "error":
        extra = " " + rec["error"][:160]
    return f"[dryrun] {tag}: {rec['status']}{extra}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="all",
                    choices=["all"] + list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--dp", type=int, default=None)
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--moe-dispatch", default="auto",
                    choices=["auto", "fused", "ragged", "batched"])
    ap.add_argument("--rwkv-chunk", type=int, default=0)
    ap.add_argument("--sp-comm", default="native", choices=["native", "int8"])
    ap.add_argument("--cf", type=float, default=None,
                    help="override MoE capacity factor")
    ap.add_argument("--serve-fsdp", action="store_true",
                    help="decode parameters FSDP over dp (default: whole "
                         "on each dp rank, as the prefill's)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--schedule", default=None)
    ap.add_argument("--attn-block", type=int, default=None)
    ap.add_argument("--no-gather-cast", action="store_true")
    args = ap.parse_args(argv)
    for name, why in DEPARTURES.items():
        if getattr(args, name) not in (None, False):
            ap.error(f"--{name.replace('_', '-')} has no counterpart in the "
                     f"port: {why}")

    archs = ASSIGNED if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    if args.dp is not None or args.tp is not None:
        meshes = [(args.dp or 1, args.tp or 1)]
    elif args.both_meshes:
        meshes = [SINGLE_POD, MULTI_POD]
    else:
        meshes = [MULTI_POD if args.multi_pod else SINGLE_POD]
    os.makedirs(args.out, exist_ok=True)
    flags = dataclasses.replace(M.DEFAULT_FLAGS,
                                moe_dispatch=args.moe_dispatch,
                                rwkv_chunk=args.rwkv_chunk)
    for arch in archs:
        for shape in shapes:
            for dp, tp in meshes:
                tag = f"{arch}__{shape}__{mesh_name(dp, tp)}"
                if args.rank:
                    tag += f"__r{args.rank}"
                if args.tag:
                    tag += f"__{args.tag}"
                try:
                    rec = run_pair(arch, shape, dp, tp, flags,
                                   rank=args.rank, sp_comm=args.sp_comm,
                                   cf=args.cf, serve_fsdp=args.serve_fsdp)
                except Exception as e:  # noqa: BLE001 - one pair's failure is its record
                    rec = {"arch": arch, "shape": shape,
                           "mesh": mesh_name(dp, tp), "rank": args.rank,
                           "status": "error", "error": repr(e)[:2000],
                           "traceback": traceback.format_exc()[-4000:]}
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                print(_line(tag, rec), flush=True)


if __name__ == "__main__":
    main()
