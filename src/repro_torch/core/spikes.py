"""Loss-spike handling (paper §3.4.4 + §6.1; own copy of
`repro.core.spikes`).

Two cooperating halves:

  * the **device-side guard** (`init_guard_state` / `guard_commit`) keeps
    the EMA mean/var as 0-d tensors on the device and emits a `commit`
    flag, so the commit-or-discard of §3.4.4 is a `torch.where` on the
    device — nothing is read on the host per step;
  * the **host-side `SpikeDetector`** keeps the policy: narrow/wide
    classification, the retry queue and the LR-halving window.  The
    trainer feeds it from drained metrics via `ingest` (the spiking batch
    itself goes to the data pipeline's retry lane, as the reference's
    trainer sends it); the per-step `observe` entry point, which decides
    the skip itself, remains for synchronous callers.  Its state goes
    into checkpoints (`state_dict` / `load_state_dict`).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class SpikeConfig:
    ema_decay: float = 0.98
    sigma_threshold: float = 4.0     # spike if loss > mean + sigma*std
    abs_threshold: float = 0.75      # ... or loss - mean > abs_threshold
    wide_after: int = 3              # consecutive spikes => wide spike
    lr_reduce_factor: float = 0.5    # persistent spike LR response
    lr_reduce_steps: int = 50        # steps the reduction stays active
    warmup_steps: int = 20           # no detection before stats settle
    # §3.4.4 footnote 2: also veto the commit when the grad norm exceeds
    # its EMA mean + gnorm_sigma_threshold * std (or is non-finite).
    # None keeps the loss-only guard and its 4-leaf state.
    gnorm_sigma_threshold: Optional[float] = None


# ---------------------------------------------------------------------------
# device-side fast path: EMA state + commit flag on the device
# ---------------------------------------------------------------------------


def init_guard_state(cfg: Optional[SpikeConfig] = None,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """The guard's EMA state as 0-d tensors on `device`; a gnorm-keyed
    config adds a second EMA pair (gmean/gvar)."""
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    state = {"mean": torch.zeros((), **f32),
             "var": torch.full((), 0.25, **f32),
             "n": torch.zeros((), **i32),
             "seeded": torch.zeros((), **i32)}
    if cfg is not None and cfg.gnorm_sigma_threshold is not None:
        state["gmean"] = torch.zeros((), **f32)
        state["gvar"] = torch.full((), 0.25, **f32)
    return state


def guard_commit(cfg: SpikeConfig, state: Dict[str, torch.Tensor],
                 loss: torch.Tensor, gnorm: Optional[torch.Tensor] = None):
    """Commit decision on the device (mirrors `SpikeDetector.is_spike`).

    Returns ``(commit, new_state)``: ``commit`` is a 0-d bool tensor —
    False when `loss` spikes above the EMA statistic (or is non-finite).
    Spiking losses do not update the running stats; the first committed
    observation seeds mean=loss, var=0.25.  With
    ``cfg.gnorm_sigma_threshold`` and a `gnorm`, a second EMA over the
    grad norm vetoes the same commit flag."""
    loss = loss.float()
    first = state["seeded"] == 0
    mean = torch.where(first, loss, state["mean"])
    # n counts observations including this one, like the host detector's
    # pre-check increment in `observe`
    warm = (state["n"] + 1) < cfg.warmup_steps
    std = torch.clamp(torch.sqrt(state["var"]), min=1e-3)
    spike = (~warm) & ((loss > mean + cfg.sigma_threshold * std)
                       | (loss - mean > cfg.abs_threshold))
    commit = (~spike) & torch.isfinite(loss)

    use_gnorm = (cfg.gnorm_sigma_threshold is not None
                 and "gmean" in state and gnorm is not None)
    if use_gnorm:
        gnorm = gnorm.float()
        gmean = torch.where(first, gnorm, state["gmean"])
        gstd = torch.clamp(torch.sqrt(state["gvar"]), min=1e-3)
        gspike = (~warm) & (gnorm > gmean
                            + cfg.gnorm_sigma_threshold * gstd)
        commit = commit & (~gspike) & torch.isfinite(gnorm)

    d = cfg.ema_decay
    delta = loss - mean
    new_state = dict(state)
    new_state["mean"] = torch.where(commit, mean + (1 - d) * delta,
                                    state["mean"])
    new_state["var"] = torch.where(
        commit & ~first, d * state["var"] + (1 - d) * delta * delta,
        state["var"])
    new_state["n"] = state["n"] + 1
    new_state["seeded"] = torch.where(commit,
                                      torch.ones_like(state["seeded"]),
                                      state["seeded"])
    if use_gnorm:
        gdelta = gnorm - gmean
        new_state["gmean"] = torch.where(commit, gmean + (1 - d) * gdelta,
                                         state["gmean"])
        new_state["gvar"] = torch.where(
            commit & ~first, d * state["gvar"] + (1 - d) * gdelta * gdelta,
            state["gvar"])
    return commit, new_state


@dataclasses.dataclass
class SpikeEvent:
    step: int
    loss: float
    kind: str                        # "narrow" | "wide"
    action: str                      # "skip" | "skip+retry" | "skip+lr"


class SpikeDetector:
    # `lr_reduced_until` is part of the public contract: the trainer reads
    # it (via `lr_scale_for`) before the first observe/ingest call, so it
    # must exist — explicitly initialized — from construction.
    lr_reduced_until: int

    def __init__(self, cfg: SpikeConfig = SpikeConfig()):
        self.cfg = cfg
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.n = 0
        self.consecutive = 0
        self.lr_reduced_until = -1
        self.events: List[SpikeEvent] = []
        self.retry_queue: Deque[Any] = deque()

    # -- LR policy ------------------------------------------------------------
    def lr_scale_for(self, step: int) -> float:
        """LR multiplier for `step`: `lr_reduce_factor` while inside the
        reduction window opened by a wide spike, 1.0 otherwise.  Safe to
        call before any observation (the window starts closed)."""
        return (self.cfg.lr_reduce_factor
                if step <= self.lr_reduced_until else 1.0)

    # -- statistics -----------------------------------------------------------
    def _update_stats(self, loss: float):
        d = self.cfg.ema_decay
        if self.mean is None:
            self.mean, self.var = loss, 0.25
        else:
            delta = loss - self.mean
            self.mean += (1 - d) * delta
            self.var = d * self.var + (1 - d) * delta * delta

    def is_spike(self, loss: float) -> bool:
        if self.mean is None or self.n < self.cfg.warmup_steps:
            return False
        std = max(np.sqrt(self.var), 1e-3)
        return (loss > self.mean + self.cfg.sigma_threshold * std
                or loss - self.mean > self.cfg.abs_threshold)

    # -- shared policy block ----------------------------------------------------
    def _record(self, step: int, loss: float, skipped: bool,
                batch: Any = None) -> Dict[str, Any]:
        """Narrow/wide classification, sample-retry queueing, LR-halving
        window, event log — everything downstream of the skip decision."""
        if not skipped:
            self.consecutive = 0
            self._update_stats(loss)
            return {"skip": False, "kind": None}
        self.consecutive += 1
        wide = self.consecutive >= self.cfg.wide_after
        action = "skip+retry"
        if batch is not None:
            self.retry_queue.append(batch)      # re-inject later (§3.4.4)
        if wide:
            # persistent spike: also reduce LR for a window of steps
            self.lr_reduced_until = step + self.cfg.lr_reduce_steps
            action = "skip+lr"
        self.events.append(SpikeEvent(step, loss, "wide" if wide else
                                      "narrow", action))
        # spiking losses do NOT update the running stats
        return {"skip": True, "kind": "wide" if wide else "narrow"}

    # -- synchronous entry: detector decides the skip itself ------------------
    def observe(self, step: int, loss: float, batch: Any = None
                ) -> Dict[str, Any]:
        """Returns {'skip': bool, 'lr_scale': float, 'kind': str|None}."""
        self.n += 1
        spike = self.is_spike(loss)
        out = self._record(step, loss, spike, batch)
        return {**out, "lr_scale": self.lr_scale_for(step)}

    # -- async entry: the skip decision was already made on device -----------
    def ingest(self, step: int, loss: float, skipped: bool,
               batch: Any = None) -> Dict[str, Any]:
        """Record one drained step whose commit/discard already happened on
        device (`guard_commit`).  Mirrors `observe` minus the skip
        decision itself."""
        self.n += 1
        return self._record(step, loss, skipped, batch)

    def pop_retry(self) -> Optional[Any]:
        """Pull a saved batch for random re-injection."""
        if self.retry_queue:
            return self.retry_queue.popleft()
        return None

    # -- checkpoint resume ----------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {"mean": self.mean, "var": self.var, "n": self.n,
                "consecutive": self.consecutive,
                "lr_reduced_until": self.lr_reduced_until,
                "events": list(self.events),
                "retry_queue": list(self.retry_queue)}

    def load_state_dict(self, s: Dict[str, Any]):
        self.mean = s["mean"]
        self.var = s["var"]
        self.n = s["n"]
        self.consecutive = s["consecutive"]
        self.lr_reduced_until = s["lr_reduced_until"]
        self.events = list(s["events"])
        self.retry_queue = deque(s["retry_queue"])


def inject_synthetic_spikes(losses: np.ndarray, steps: List[int],
                            magnitude: float = 3.0) -> np.ndarray:
    """Test/benchmark helper: overlay spikes on a loss curve."""
    out = losses.copy()
    for s in steps:
        for j, decay in enumerate([1.0, 0.6, 0.3]):
            if s + j < len(out):
                out[s + j] += magnitude * decay
    return out
