"""Learning-rate and batch-size schedules (paper §3.4; own copy of
`repro.optim.schedule`).

* WSD (warmup–stable–decay): linear warmup over the first `warmup_steps`
  to `max_lr`, held stable, halved once ~60% of the training tokens are
  consumed (§3.4.1).  The halving point is clamped to the end of the
  warmup ramp so small `total_steps` never give a non-monotone warmup.
* Annealing: inverse-square-root decay from 1.2e-4 to 1.2e-8 (§3.4.3).
* Batch-size warmup (§3.4.1): `BatchSizeWarmup` is the raw size schedule;
  `AccumWarmup` the engine-facing form — the microbatch shape stays fixed
  and the global batch grows by scheduling the number of accumulated
  microbatches per optimizer step.

Every schedule evaluates on the host, in Python floats: the trainer calls
it every step before dispatch, and a device evaluation there would wait
for the step in flight.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class WSDSchedule:
    max_lr: float = 2.4e-4
    warmup_steps: int = 2_000
    halve_frac: float = 0.6          # halve LR at 60% of total tokens
    total_steps: int = 100_000

    def __call__(self, step: int) -> float:
        warm = self.max_lr * min(step / max(self.warmup_steps, 1), 1.0)
        halve_at = max(self.halve_frac * self.total_steps, self.warmup_steps)
        return warm * (0.5 if step >= halve_at else 1.0)


@dataclasses.dataclass(frozen=True)
class InvSqrtAnnealing:
    """§3.4.3: anneal from lr_start to lr_end with inverse-sqrt decay,
    lr(t) = lr_start / sqrt(1 + a t) with a chosen to land on lr_end at
    `steps`, never below lr_end.  `host` is the reference's name for the
    same host evaluation."""
    lr_start: float = 1.2e-4
    lr_end: float = 1.2e-8
    steps: int = 10_000

    def __call__(self, step: int) -> float:
        a = ((self.lr_start / self.lr_end) ** 2 - 1.0) / max(self.steps, 1)
        return max(self.lr_start / math.sqrt(1.0 + a * step), self.lr_end)

    host = __call__


@dataclasses.dataclass(frozen=True)
class BatchSizeWarmup:
    """§3.4.1: batch size grows 2,560 -> 8,960 sequences stepwise.

    Sizes are rounded down to `round_multiple` (never below `start`);
    None derives it from the endpoints: the largest power of two dividing
    both, capped at 256."""
    start: int = 2_560
    end: int = 8_960
    warmup_steps: int = 5_000
    increments: int = 8
    round_multiple: Optional[int] = None

    @property
    def multiple(self) -> int:
        if self.round_multiple:
            return self.round_multiple
        g = max(1, math.gcd(self.start, self.end))
        return min(256, g & -g)      # largest power of two dividing both

    def stage_for(self, step: int) -> int:
        if step >= self.warmup_steps:
            return self.increments
        return int(step / max(self.warmup_steps, 1) * self.increments)

    def size_for_stage(self, stage: int) -> int:
        if stage >= self.increments:
            return self.end
        size = self.start + (self.end - self.start) * stage // self.increments
        m = self.multiple
        return max(self.start, (size // m) * m)

    def sizes(self) -> Tuple[int, ...]:
        """Distinct batch sizes the schedule visits, ascending."""
        return tuple(sorted({self.size_for_stage(k)
                             for k in range(self.increments + 1)}))

    def __call__(self, step: int) -> int:
        return self.size_for_stage(self.stage_for(step))


@dataclasses.dataclass(frozen=True)
class AccumWarmup:
    """Engine-facing batch-size warmup (§3.4.1): fixed microbatch shape,
    scheduled accumulation count.  `start`/`end` are global batch sizes in
    sequences and must be multiples of `microbatch`."""
    microbatch: int
    start: int = 2_560
    end: int = 8_960
    warmup_steps: int = 5_000
    increments: int = 8

    def __post_init__(self):
        if self.microbatch < 1:
            raise ValueError(f"microbatch must be >= 1, got {self.microbatch}")
        if self.end < self.start:
            raise ValueError(f"end {self.end} < start {self.start}")
        for name in ("start", "end"):
            v = getattr(self, name)
            if v % self.microbatch:
                raise ValueError(
                    f"AccumWarmup {name}={v} is not a multiple of "
                    f"microbatch={self.microbatch}")

    @property
    def batch_schedule(self) -> BatchSizeWarmup:
        return BatchSizeWarmup(self.start, self.end, self.warmup_steps,
                               self.increments,
                               round_multiple=self.microbatch)

    def batch_for(self, step: int) -> int:
        """Global batch (sequences) consumed by the optimizer step."""
        return self.batch_schedule(step)

    def accum_for(self, step: int) -> int:
        """Microbatches accumulated per optimizer step at `step`."""
        return self.batch_for(step) // self.microbatch

    def stages(self) -> Tuple[int, ...]:
        """Distinct accum counts the warmup visits, ascending."""
        return tuple(s // self.microbatch
                     for s in self.batch_schedule.sizes())
