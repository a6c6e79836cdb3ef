"""EDiT — Elastic Distributed Training (paper §2.2, C5), own copy of
`repro.core.edit` for the port.

A tailored Local-SGD method: K workers run independent local
optimization and synchronize parameters with a pseudo-gradient penalty:

  1. **Anomaly elimination** — per-worker pseudo-gradient norms are
     tracked with an exponential moving average; workers whose norm
     deviates more than `anomaly_sigma` standard deviations from their
     previous statistics are excluded from the sync.
  2. **Weighted averaging** — surviving workers are averaged with weights
     inversely proportional to their pseudo-gradient norms.
  3. **Gradient clipping** — the aggregated pseudo-gradient is clipped to
     a fixed norm before the outer optimizer (momentum, `outer_lr`)
     applies it to the parameters of the previous sync.

Synchronization follows a fixed number of local steps, or, with a time
threshold, lets a fast worker take more local steps than a slow one
(`worker_speeds`); `simulate_sync_timeline` is the numpy step-time model
of the Fig. 8 benchmark.

As in the reference, the K workers run one after the other on one device
(`EDiTTrainer`); trees keep the reference's nested-dict layout, so
`interop.params_from_numpy` maps both sides.  The port's train step
updates params and optimizer state in place, so every worker is a replica
of its own (real copies, never a view of the base) and a worker's
optimizer state carries across rounds while its params restart from the
synced base.

Intended departure: `edit_sync` walks the tree leaf by leaf — each
worker's pseudo-gradient leaf is formed, squared and summed into its
norm, then formed again for the weighted average — instead of holding K
pseudo-gradient trees.  The per-element arithmetic is the reference's;
only the fp32 summation order of the norms differs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.optim.adamw import leaves


@dataclasses.dataclass(frozen=True)
class EDiTConfig:
    sync_every: int = 8              # local steps between syncs (H)
    time_threshold_s: Optional[float] = None   # if set: time-based sync
    anomaly_sigma: float = 2.0
    ema_decay: float = 0.9
    clip_norm: float = 1.0
    outer_momentum: float = 0.9      # outer (pseudo-gradient) momentum
    outer_lr: float = 1.0


def tree_map(fn: Callable, *trees):
    """`fn` over corresponding leaves of nested dicts and lists of one
    layout."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], list):
        return [tree_map(fn, *nodes) for nodes in zip(*trees)]
    return fn(*trees)


def tree_sub(a, b):
    return tree_map(lambda x, y: x.float() - y.float(), a, b)


def tree_norm(t) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(l.float() ** 2) for l in leaves(t)))


def layer_names(params: Dict[str, Any]) -> List[str]:
    """Top-level layer-wise sync units (embed / blocks / norms / head)."""
    return sorted(params.keys())


# ---------------------------------------------------------------------------
# the EDiT synchronization step
# ---------------------------------------------------------------------------


@torch.no_grad()
def edit_sync(base_params, worker_params: Sequence[Any],
              ema_state: Dict[str, torch.Tensor], outer_m,
              cfg: EDiTConfig):
    """One EDiT synchronization.

    base_params: global params at the previous sync point.
    worker_params: K worker replicas after their local steps.
    ema_state: {'mean': (K,), 'var': (K,), 'count': ()} EMA of
    pseudo-gradient norms.  outer_m: outer momentum (fp32, like params).

    Returns (new_params, new_ema, new_outer_m, info); new trees, the
    inputs are not written.  Nothing is read on the host."""
    K = len(worker_params)
    base_l = leaves(base_params)
    work_l = [leaves(w) for w in worker_params]
    # pseudo gradients g_i = theta_base - theta_i, and their norms, one
    # leaf at a time
    sq: List[Any] = [0] * K
    for j, b in enumerate(base_l):
        for i in range(K):
            g = b.float() - work_l[i][j].float()
            sq[i] = sq[i] + torch.sum(g ** 2)
    norms = torch.sqrt(torch.stack(sq))                       # (K,)

    # (1) anomaly elimination: each worker's norm against its *previous*
    # EMA statistics; the first two syncs (no history yet) keep everyone
    count = ema_state.get("count")
    if count is None:
        count = torch.zeros((), dtype=torch.int32, device=norms.device)
    sigma = torch.sqrt(ema_state["var"] + 1e-12)
    z = torch.abs(norms - ema_state["mean"]) / torch.clamp(sigma, min=1e-6)
    keep = (z <= cfg.anomaly_sigma) | (count < 2)
    # never eliminate everyone
    keep = torch.where(torch.any(keep), keep, torch.ones_like(keep))
    # the EMA takes kept workers only (a faulty worker must not drag its
    # own acceptance threshold up)
    d = cfg.ema_decay
    new_mean = torch.where(keep, d * ema_state["mean"] + (1 - d) * norms,
                           ema_state["mean"])
    new_var = torch.where(keep, d * ema_state["var"]
                          + (1 - d) * (norms - new_mean) ** 2,
                          ema_state["var"])

    # (2) weighted averaging: w_i ~ 1 / (norm_i + eps), anomalies get 0
    raw_w = torch.where(keep, 1.0 / (norms + 1e-8), 0.0)
    weights = raw_w / torch.sum(raw_w)

    def avg(b, *ws):
        acc = 0
        for i, w in enumerate(ws):
            acc = acc + weights[i] * (b.float() - w.float())
        return acc

    pg_avg = tree_map(avg, base_params, *worker_params)

    # (3) clip the aggregated pseudo gradient
    n = tree_norm(pg_avg)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(n, min=1e-12), max=1.0)

    # outer update with momentum: theta <- theta_base - lr * m
    new_m = tree_map(lambda m, g: cfg.outer_momentum * m + g * scale,
                     outer_m, pg_avg)
    del pg_avg
    new_params = tree_map(
        lambda p, m: (p.float() - cfg.outer_lr * m).to(p.dtype),
        base_params, new_m)

    info = {"pg_norms": norms, "kept": keep, "weights": weights,
            "pg_avg_norm": n}
    new_ema = {"mean": new_mean, "var": new_var, "count": count + 1}
    return new_params, new_ema, new_m, info


def init_ema(num_workers: int, device="cpu") -> Dict[str, torch.Tensor]:
    return {"mean": torch.zeros((num_workers,), dtype=torch.float32,
                                device=device),
            "var": torch.ones((num_workers,), dtype=torch.float32,
                              device=device),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def init_outer_momentum(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


# ---------------------------------------------------------------------------
# the EDiT trainer: K workers one after the other, local steps, sync
# ---------------------------------------------------------------------------


class EDiTTrainer:
    """Multi-worker local-SGD trainer.

    Each worker is a full model replica trained by `train_step` ``(params,
    opt, batch, step, lr) -> (params, opt, loss)`` with its own optimizer
    state (None before its first step); `worker_speeds` models
    heterogeneous hardware (steps per unit time) for time-based
    synchronization.  A round reads the device once, after its sync."""

    def __init__(self, init_params, train_step: Callable, cfg: EDiTConfig,
                 num_workers: int,
                 worker_speeds: Optional[Sequence[float]] = None):
        self.cfg = cfg
        self.K = num_workers
        self.speeds = list(worker_speeds or [1.0] * num_workers)
        self.train_step = train_step
        self.base = init_params
        # replicas with storage of their own
        self.workers = [tree_map(lambda t: t.detach().clone(), init_params)
                        for _ in range(num_workers)]
        self.opt_states: List[Any] = [None] * num_workers
        self.ema = init_ema(num_workers, leaves(init_params)[0].device)
        self.outer_m = init_outer_momentum(init_params)
        self.step = 0
        self.history: List[Dict] = []

    def round(self, batches_per_worker: Sequence[Sequence[Any]],
              lr: float = 1e-3):
        """One sync round: local steps per worker then an EDiT sync.

        With time-based sync, worker i runs round(speed_i * H) local
        steps; with step-based sync every worker runs exactly H."""
        cfg = self.cfg
        losses = []
        for i in range(self.K):
            if cfg.time_threshold_s is not None:
                n_local = max(1, int(round(self.speeds[i] * cfg.sync_every)))
            else:
                n_local = cfg.sync_every
            batches = batches_per_worker[i]
            w, opt = self.workers[i], self.opt_states[i]
            for j in range(n_local):
                batch = batches[j % len(batches)]
                w, opt, loss = self.train_step(w, opt, batch,
                                               self.step + j, lr)
                losses.append(loss.detach().float())
            self.workers[i], self.opt_states[i] = w, opt

        self.base, self.ema, self.outer_m, info = edit_sync(
            self.base, self.workers, self.ema, self.outer_m, cfg)
        # workers restart from the synced point, in their own storage
        with torch.no_grad():
            for w in self.workers:
                for dst, src in zip(leaves(w), leaves(self.base)):
                    dst.copy_(src)
        self.step += cfg.sync_every
        host = torch.cat([torch.stack(losses), info["weights"],
                          info["pg_avg_norm"][None],
                          info["kept"].float()]).cpu().numpy()
        K = self.K
        weights = host[-2 * K - 1:-K - 1]
        rec = {"step": self.step,
               "mean_loss": float(np.mean(host[:len(losses)].tolist())),
               "kept": (host[-K:] > 0.5).tolist(),
               "weights": weights.round(4).tolist(),
               "pg_avg_norm": float(host[-K - 1])}
        self.history.append(rec)
        return rec


# ---------------------------------------------------------------------------
# step-time model for the Fig. 8 benchmark (no hardware required)
# ---------------------------------------------------------------------------


def simulate_sync_timeline(n_workers: int, n_steps: int, *,
                           straggler_frac: float = 0.05,
                           straggler_slowdown: float = 3.0,
                           base_step_s: float = 1.0,
                           sync_every: int = 8,
                           layer_sync_overlap: float = 0.8,
                           sync_cost_s: float = 0.5,
                           seed: int = 0) -> Dict[str, float]:
    """Wall-clock comparison: synchronous all-reduce vs EDiT.

    Baseline: every step waits for the slowest worker and pays the full
    gradient all-reduce.  EDiT: workers run locally (no per-step wait);
    every `sync_every` steps a layer-wise sync costs sync_cost_s, of which
    `layer_sync_overlap` is hidden under forward compute (prefetch).
    """
    rng = np.random.RandomState(seed)
    # per-step per-worker times with occasional stragglers
    times = base_step_s * (1 + 0.05 * rng.rand(n_steps, n_workers))
    mask = rng.rand(n_steps, n_workers) < straggler_frac
    times = np.where(mask, times * straggler_slowdown, times)

    sync_wall = float(np.sum(times.max(axis=1) + sync_cost_s))
    # EDiT: each worker proceeds at its own pace between syncs
    edit_wall = 0.0
    for s0 in range(0, n_steps, sync_every):
        seg = times[s0:s0 + sync_every]
        per_worker = seg.sum(axis=0)
        edit_wall += float(per_worker.max()) \
            + sync_cost_s * (1.0 - layer_sync_overlap)
    speedup = sync_wall / edit_wall
    return {"sync_wall_s": sync_wall, "edit_wall_s": edit_wall,
            "speedup": speedup,
            "time_saved_frac": 1.0 - edit_wall / sync_wall}
