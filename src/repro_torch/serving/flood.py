"""Flood — high-efficiency offline inference engine (paper §2.4, C12);
the port's own copy of the framework-free `repro.serving.flood`.

The paper's design, as the scheduler implements it:

  * **Fully pipeline-parallel** execution: the model's layers are split
    into `n_stages` stage functions; micro-batches of requests flow
    through the stage pipeline so every stage computes each tick.
  * **N_stages + 1 in-flight micro-batches**: the paper keeps one extra
    process waiting on the first stage so the accelerator never idles —
    here the scheduler keeps `n_stages + 1` micro-batches circulating.
  * **Segment KV cache** with extend/append/wait + prefix caching
    (`segment_cache.py`).
  * The baseline for the Table-3-shaped comparison is a TP-style engine
    that runs one global batch synchronously per token (per-step global
    sync = the communication-heavy pattern the paper attributes to TP),
    implemented in `baseline_step_engine`.

The event-driven scheduler is real; per-stage timing uses either wall
clock (CPU execution) or a caller-supplied cost model (for the pipeline
utilization benchmark).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.segment_cache import SegmentCache


def quantize_microbatch(n: int, multiple: int) -> int:
    """Round a micro-batch size up to a multiple.  The expert-parallel
    MoE decode path (core/moe.py dispatch="ep") slices token ownership
    over the tp mesh axis, so decode batches must satisfy B % tp == 0 —
    the single place both the engine and its callers quantize from."""
    if multiple > 1 and n % multiple:
        n += multiple - n % multiple
    return n


@dataclasses.dataclass
class GenRequest:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    prefix_key: Optional[str] = None


@dataclasses.dataclass
class PipelineStats:
    ticks: int = 0
    stage_busy: Optional[np.ndarray] = None
    tokens_out: int = 0
    wall_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / max(self.wall_s, 1e-9)

    @property
    def utilization(self) -> float:
        if self.stage_busy is None or self.ticks == 0:
            return 0.0
        return float(self.stage_busy.mean() / self.ticks)


class FloodEngine:
    """Pipeline-parallel micro-batch scheduler.

    `stage_fns[i](micro_state) -> micro_state` carries a micro-batch's
    activations through stage i; `head_fn(micro_state) -> tokens` samples.
    For pure scheduling benchmarks, stage_fns may be cost-model stubs.
    """

    def __init__(self, stage_fns: Sequence[Callable], head_fn: Callable,
                 embed_fn: Callable, *, cache: Optional[SegmentCache] = None,
                 microbatch: int = 8, batch_multiple: int = 1):
        """`batch_multiple` quantizes the micro-batch size via
        `quantize_microbatch` (EP decode constraint: B % tp == 0); pass
        batch_multiple=tp and the scheduler rounds the micro-batch up
        (embed_fn pads the tail).  Callers that compile a fixed decode
        batch must quantize with the same helper."""
        self.stage_fns = list(stage_fns)
        self.head_fn = head_fn
        self.embed_fn = embed_fn
        self.S = len(self.stage_fns)
        self.micro = quantize_microbatch(microbatch, batch_multiple)
        self.cache = cache or SegmentCache(max_tokens=1 << 20)
        self.pending: Deque[GenRequest] = deque()
        self.stats = PipelineStats(stage_busy=np.zeros(self.S))

    def submit(self, reqs: Sequence[GenRequest]):
        for r in reqs:
            admitted = self.cache.admit(r.rid, len(r.prompt), r.max_new,
                                        prefix_key=r.prefix_key)
            self.pending.append(r)
            if not admitted:
                r.done = False  # parked; will retry on release

    def _make_micro(self) -> Optional[Dict[str, Any]]:
        batch = []
        while self.pending and len(batch) < self.micro:
            r = self.pending.popleft()
            if not r.done:
                batch.append(r)
        if not batch:
            return None
        return {"reqs": batch, "x": self.embed_fn(batch), "stage": 0}

    def run(self, max_ticks: int = 100000) -> PipelineStats:
        """Event-driven pipeline: n_stages+1 micro-batches in flight.

        One tick = one stage-time unit across ALL stages concurrently (the
        stages are distinct accelerators in deployment): each stage
        processes at most one micro-batch per tick; a micro-batch that
        clears the last stage emits tokens and loops back to stage 0 for
        its next decode step.
        """
        t0 = time.perf_counter()
        inflight: List[Dict] = []
        ticks = 0
        while ticks < max_ticks:
            # keep S+1 micro-batches circulating (the paper's extra
            # process waiting on stage 0)
            while len(inflight) < self.S + 1:
                mb = self._make_micro()
                if mb is None:
                    break
                inflight.append(mb)
            if not inflight and not self.pending:
                break
            ticks += 1
            # advance back-to-front: at most one micro-batch per stage
            for s in range(self.S - 1, -1, -1):
                for mb in inflight:
                    if mb["stage"] == s:
                        mb["x"] = self.stage_fns[s](mb["x"])
                        self.stats.stage_busy[s] += 1
                        mb["stage"] += 1
                        break
            # completions: emit a token, then loop back to stage 0
            for mb in list(inflight):
                if mb["stage"] < self.S:
                    continue
                toks = self.head_fn(mb["x"], mb["reqs"])
                for r, t in zip(mb["reqs"], toks):
                    if self.cache.write_token(r.rid) is None:
                        continue          # waiting on cache space
                    r.out.append(int(t))
                    self.stats.tokens_out += 1
                    if len(r.out) >= r.max_new:
                        r.done = True
                        self.cache.release(r.rid)
                alive = [r for r in mb["reqs"] if not r.done]
                if alive:
                    mb["reqs"] = alive
                    mb["x"] = self.embed_fn(alive)
                    mb["stage"] = 0
                else:
                    inflight.remove(mb)
        self.stats.ticks = ticks
        self.stats.wall_s = time.perf_counter() - t0
        return self.stats


# ---------------------------------------------------------------------------
# baseline: synchronous global-batch engine (TP-style pattern)
# ---------------------------------------------------------------------------


def baseline_step_engine(step_fn: Callable, embed_fn: Callable,
                         reqs: Sequence[GenRequest],
                         sync_overhead_s: float = 0.0) -> PipelineStats:
    """One global batch; every token step runs the whole model and pays a
    global synchronization (the TP communication pattern)."""
    stats = PipelineStats()
    t0 = time.perf_counter()
    alive = [r for r in reqs]
    while alive:
        x = embed_fn(alive)
        toks = step_fn(x, alive)
        if sync_overhead_s:
            time.sleep(sync_overhead_s)
        for r, t in zip(alive, toks):
            r.out.append(int(t))
            stats.tokens_out += 1
            if len(r.out) >= r.max_new:
                r.done = True
        alive = [r for r in alive if not r.done]
    stats.wall_s = time.perf_counter() - t0
    return stats
