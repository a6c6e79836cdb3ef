"""Training engine at tp=1 (counterpart of `repro.training.trainer`):

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
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Any, Dict, List, Optional

import torch

from repro_torch import api
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
    # run every step dispatch under torch.cuda.set_sync_debug_mode("error")
    # so any device->host sync inside it raises
    debug_guards: bool = False


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
        """Armed (debug_guards, on a card) the step dispatch runs under
        torch.cuda.set_sync_debug_mode("error"): a device->host sync in
        it raises.  Metrics must stay on the device until `_drain`."""
        if self.cfg.debug_guards and self.device.type == "cuda":
            return _sync_debug_error()
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
        beside a host sidecar (step, accum stage, pipeline stream with
        the batches packed ahead, detector) so `restore` continues the
        run exactly."""
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
        self.pcache.save(name, self._state_tree(), block=False)
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

    def restore(self, name: str = "latest") -> str:
        """Resume from a PCache checkpoint: the saved values go into the
        trainer's tensors (which the step updates in place), the data
        stream continues from its saved position (the batches that were
        packed ahead first), and the spike policy and the accum stage
        carry over."""
        if self.pcache is None:
            raise ValueError("TrainConfig.checkpoint_dir is unset")
        self.pcache.wait()
        if name == "latest":
            found = self.pcache.latest()
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
        loaded = self.pcache.load(name, like)
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


@contextlib.contextmanager
def _sync_debug_error():
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
