"""Training engine (counterpart of `repro.training.trainer`):

  model (Runner) + AdamW + WSD schedule + microbatch grad accumulation
  + batch-size warmup via scheduled accumulation (§3.4.1) + device-side
  loss-spike guard (§3.4.4) + XPUTimer spans.

Division of labour, as in the reference:

  * the **train step** (`Runner.make_train_step`) owns the fast path: fp32
    master params and AdamW moments updated in place, fp32 grad
    accumulation over microbatches, and the spike commit-or-discard as a
    `torch.where` on an EMA loss statistic kept on the device — no read
    of a device value on the host per step;
  * the **host loop** owns the policy: each step's device metrics wait in
    a pending list and are read in one transfer every `log_every` steps
    (`_drain`), feeding the `SpikeDetector`'s narrow/wide classification,
    the sample-retry queue and the LR-halving window; `DataPipeline`
    batches are packed ahead on a background thread; PCache saves the
    params, moments and guard state with background writers, and
    `restore` resumes the run (the pipeline's stream, the batches packed
    ahead, the detector and the accum stage) exactly.

Step i's router-warmup noise comes from the threefry key
``fold_in(prng_key(seed), i)``, as in the reference, so a resumed run
draws what the unbroken run drew.

On a (dp, tp) mesh every rank runs its own Trainer over the same seeded
pipeline: each step gets the same global batch on every rank, the train
step keeps the rank's dp rows (`api.local_rows`) and returns the mesh's
reduced metrics, so every rank's host policy sees the same numbers.
Checkpoints stay mesh-free on disk (each leaf whole, the reference's
format): every rank writes the slices it holds of each leaf file in the
background (`PCache.save_sharded`), rank 0 the manifest and the host
sidecar, and a restore reads each rank's slice through the parameters',
the moments' and the guard state's spec trees, at any mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Any, Dict, List, Optional

import torch

from repro_torch import api, sharding
from repro_torch.analysis import contracts
from repro_torch.checkpoint.pcache import PCache
from repro_torch.core import spikes as spikes_lib
from repro_torch.core.spikes import SpikeConfig, SpikeDetector
from repro_torch.data.pipeline import DataPipeline, Prefetcher
from repro_torch.models import prng
from repro_torch.optim import adamw
from repro_torch.optim.schedule import AccumWarmup, WSDSchedule
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.xputimer import XPUTimer


@dataclasses.dataclass
class TrainConfig:
    n_steps: int = 100
    lr_schedule: WSDSchedule = dataclasses.field(
        default_factory=lambda: WSDSchedule(max_lr=1e-3, warmup_steps=20,
                                            total_steps=1000))
    opt: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)
    spike: SpikeConfig = dataclasses.field(default_factory=SpikeConfig)
    accum_steps: int = 1               # microbatches per optimizer step
    bs_warmup: Optional[AccumWarmup] = None   # §3.4.1 scheduled accumulation
    prefetch_depth: int = 2            # batches packed ahead of the device
    log_every: int = 10                # metrics-drain (host read) period
    checkpoint_every: int = 0          # 0 = off
    checkpoint_dir: Optional[str] = None
    seed: int = 0
    # run every step dispatch under contracts.transfer_guard so any
    # device->host sync inside it raises; None = read the
    # REPRO_DEBUG_GUARDS env var
    debug_guards: Optional[bool] = None


class Trainer:
    def __init__(self, runner: api.Runner, pipeline: DataPipeline,
                 cfg: TrainConfig, timer: Optional[XPUTimer] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.runner = runner
        self.pipeline = pipeline
        self.cfg = cfg
        self.device = runner.device
        self.registry = registry if registry is not None else MetricsRegistry()
        self.timer = timer or XPUTimer(registry=self.registry)
        if self.timer.registry is None:
            self.timer.registry = self.registry
        self._m_loss = self.registry.gauge(
            "train_loss", "last drained training loss")
        self._m_lr = self.registry.gauge(
            "train_lr", "last drained learning rate")
        self._m_steps = self.registry.counter(
            "train_steps_total", "optimizer steps drained")
        self.detector = SpikeDetector(cfg.spike)
        self.debug_guards = (contracts.env_debug_guards()
                             if cfg.debug_guards is None
                             else cfg.debug_guards)
        if cfg.bs_warmup is not None:
            if cfg.bs_warmup.microbatch != pipeline.cfg.batch_size:
                raise ValueError(
                    f"bs_warmup.microbatch={cfg.bs_warmup.microbatch} must "
                    f"equal pipeline batch_size={pipeline.cfg.batch_size}")
        self.step_fn = runner.make_train_step(cfg.opt, spike_guard=cfg.spike)
        self.params = runner.init_train_params(cfg.seed)
        self.opt_state = adamw.init_opt_state(self.params)
        self.guard_state = spikes_lib.init_guard_state(cfg.spike,
                                                       self.device)
        self.rng = prng.prng_key(cfg.seed, self.device)
        self.step = 0                  # next step index to execute
        # the accum stage the run is in: the last step's, or after
        # `restore` the checkpoint's stage for the next step
        self._accum = self._accum_for(0)
        self.history: List[Dict[str, float]] = []
        # one record per dispatched-but-undrained step: (step, lr,
        # device metrics, accum, host batch for the retry lane)
        self._pending: List[Any] = []
        self._prefetcher: Optional[Prefetcher] = None
        self._preload: List[Dict] = []     # restored batches packed ahead
        self.pcache = (PCache(cfg.checkpoint_dir) if cfg.checkpoint_dir
                       else None)

    # -- data ----------------------------------------------------------------
    def _accum_for(self, step: int) -> int:
        """Accumulation count scheduled for global step `step`."""
        if self.cfg.bs_warmup is not None:
            return self.cfg.bs_warmup.accum_for(step)
        return self.cfg.accum_steps

    def _ensure_prefetcher(self):
        if self._prefetcher is None:
            # the producer packs for step `step + len(preload) + k`: the
            # restored batches cover the steps in between, so each packed
            # macrobatch lands at the granularity the warmup schedules
            # for the step that will consume it
            produce_step = itertools.count(self.step + len(self._preload))
            self._prefetcher = Prefetcher(
                lambda: self.pipeline.next_macrobatch(
                    self._accum_for(next(produce_step))),
                depth=max(1, self.cfg.prefetch_depth),
                preload=self._preload)
            self._preload = []

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        """Host batch -> int64 tensors on the device; from pinned memory
        and without waiting when the device is a card."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(v).long()
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    # -- main loop -----------------------------------------------------------
    def train(self, n_steps: Optional[int] = None) -> List[Dict[str, float]]:
        """Run until the global step counter reaches `n_steps` (default
        `cfg.n_steps`): after `restore`, the rest of the original
        schedule."""
        cfg = self.cfg
        end = cfg.n_steps if n_steps is None else n_steps
        if self.step >= end:
            return self.history
        self._ensure_prefetcher()
        while self.step < end:
            i = self.step
            accum = self._accum = self._accum_for(i)
            with self.timer.span("data"):
                batch = self._prefetcher.get()
                dbatch = self._to_device(batch)
            lr = cfg.lr_schedule(i) * self.detector.lr_scale_for(i)
            with self.timer.span("step"), \
                    self.timer.device_span("step", self.device), \
                    self._step_guard():
                # no host read here: the device decides commit/discard
                # itself and the metrics stay on the device
                (self.params, self.opt_state, self.guard_state,
                 metrics) = self.step_fn(
                    self.params, self.opt_state, self.guard_state, dbatch,
                    i, prng.fold_in(self.rng, i), lr)
            self._pending.append((i, lr, metrics, accum, batch))
            self.step += 1
            ckpt = bool(self.pcache is not None and cfg.checkpoint_every
                        and self.step % cfg.checkpoint_every == 0)
            # log_every=0 means no periodic logging, not no policy: drain
            # per step so spike retry / LR-halving never starve
            if (self.step % (cfg.log_every or 1) == 0 or ckpt
                    or self.step >= end):
                self._drain()
            if ckpt:
                with self.timer.span("checkpoint"):
                    self.save(f"step_{self.step}")
        return self.history

    def _step_guard(self):
        """Armed (debug_guards) the step dispatch runs under a
        device->host transfer guard (a no-op without a card): metrics
        must stay on the device until `_drain`."""
        if self.debug_guards:
            return contracts.transfer_guard("disallow")
        return contextlib.nullcontext()

    # -- metrics drain ---------------------------------------------------------
    def _drain(self):
        """One host transfer for every pending step's metrics; feeds the
        host-side spike policy (classification / retry / LR window)."""
        if not self._pending:
            return
        with self.timer.span("drain"):
            keys = [sorted(m) for _, _, m, _, _ in self._pending]
            flat = torch.cat([
                torch.stack([m[k].float() for k in ks])
                for ks, (_, _, m, _, _) in zip(keys, self._pending)])
            flat = flat.cpu().tolist()
            host, j = [], 0
            for ks in keys:
                host.append(dict(zip(ks, flat[j:j + len(ks)])))
                j += len(ks)
        self.timer.collect_device()
        self.timer.count("metric_drain")
        n_commit = 0
        for (i, lr, _, accum, batch), mh in zip(self._pending, host):
            loss = mh["loss"]
            committed = mh.get("commit", 1.0) >= 0.5
            self.detector.ingest(i, loss, skipped=not committed)
            if committed:
                n_commit += 1
            else:
                # §3.4.4: the update was already discarded on the device;
                # the host re-injects the data later
                if batch is not None:
                    self.pipeline.push_retry(batch, accum)
                self.timer.count("spike_skipped")
            rec = {"step": i, "loss": loss, "lr": lr,
                   "skipped": not committed,
                   **{k: v for k, v in mh.items()
                      if k not in ("loss", "commit")}}
            self.history.append(rec)
            if self.cfg.log_every and i % self.cfg.log_every == 0:
                print(f"[train] step={i} loss={loss:.4f} lr={lr:.2e}"
                      f"{'' if committed else ' SKIP'}", flush=True)
        self.timer.gauge("commit_frac", n_commit / len(host))
        self._m_steps.inc(len(host))
        last = self.history[-1]
        self._m_loss.set(last["loss"])
        self._m_lr.set(last["lr"])
        self._pending.clear()

    # -- checkpointing ---------------------------------------------------------
    def save(self, name: str) -> str:
        """Checkpoint: the params, moments and guard state are copied to
        host memory now (PCache waits for the copy, since the step
        updates them in place) and written by its background writers,
        each rank its slices of the whole leaf files
        (`PCache.save_sharded`), beside rank 0's host sidecar (step,
        accum stage, pipeline stream with the batches packed ahead,
        detector) so `restore` continues the run exactly, at any
        mesh."""
        if self.pcache is None:
            raise ValueError("TrainConfig.checkpoint_dir is unset")
        self.pcache.wait()             # one background save in flight
        if self._prefetcher is not None:
            with self._prefetcher.paused() as pending:
                pipe_state = self.pipeline.state_dict()
                prefetched = pending
        else:
            # restore() may have staged batches without a live prefetcher
            # yet; dropping them would skip stream positions
            pipe_state = self.pipeline.state_dict()
            prefetched = list(self._preload)
        env = self.runner.env
        if env.mesh.agree(float(self.step)) != self.step:
            raise RuntimeError(f"rank {env.mesh.rank} saves step "
                               f"{self.step}, rank 0 another")
        self.pcache.save_sharded(name, self._state_tree(),
                                 self._state_specs(), env, block=False)
        if env.mesh.rank:
            return name              # rank 0 writes the host sidecar
        self.pcache.save_host(name, {
            "step": self.step,
            "accum_stage": self._accum_for(self.step),
            "pipeline": pipe_state,
            "prefetched": prefetched,
            "detector": self.detector.state_dict(),
        })
        return name

    def _state_tree(self) -> Dict[str, Any]:
        return {"params": self.params, "opt": self.opt_state,
                "guard": self.guard_state}

    def _state_specs(self) -> Dict[str, Any]:
        """The spec tree of `_state_tree`: the parameters', the moments'
        (`adamw.opt_state_specs`) and the replicated guard state's."""
        specs = self.runner.specs
        return {"params": specs, "opt": adamw.opt_state_specs(specs),
                "guard": sharding.replicated_specs(self.guard_state)}

    def restore(self, name: str = "latest") -> str:
        """Resume from a PCache checkpoint: the saved values go into the
        trainer's tensors (which the step updates in place), the data
        stream continues from its saved position (the batches that were
        packed ahead first), and the spike policy and the accum stage
        carry over."""
        if self.pcache is None:
            raise ValueError("TrainConfig.checkpoint_dir is unset")
        self.pcache.wait()
        env = self.runner.env
        if name == "latest":          # rank 0's newest on every rank
            found = self.pcache.latest()
            names = self.pcache.list_checkpoints()
            j = int(env.mesh.agree(float(
                names.index(found) if found is not None else -1)))
            found = names[j] if j >= 0 else None
            if found is None:
                raise FileNotFoundError(
                    f"no complete checkpoint in {self.pcache.root}")
            name = found
        # quiesce the producer before touching pipeline state: its thread
        # mutates the pipeline's rng and buffer
        if self._prefetcher is not None:
            self._prefetcher.stop()
            self._prefetcher = None
        like = self._state_tree()
        loaded = self.pcache.load_sharded(name, like, self._state_specs(),
                                          env)
        with torch.no_grad():
            for dst, src in zip(adamw.leaves(like), adamw.leaves(loaded)):
                dst.copy_(src)
        del loaded
        host = self.pcache.load_host(name)
        self.step = host["step"]
        self._accum = host["accum_stage"]
        self.pipeline.load_state_dict(host["pipeline"])
        self.detector.load_state_dict(host["detector"])
        self._preload = list(host["prefetched"])
        self._pending.clear()
        return name

    def close(self):
        """Stop the prefetch thread and wait for the checkpoint writers."""
        if self._prefetcher is not None:
            self._prefetcher.stop()
            self._prefetcher = None
        if self.pcache is not None:
            self.pcache.wait()

