"""Online continuous-batching serving engine over a paged device KV cache
(counterpart of `repro.serving.online`, greedy slice).

* **Fixed-shape serve steps.**  `max_slots` request slots; one paged
  decode tick over all slots (`api.Runner.make_paged_decode_step`) and
  one chunked-prefill chunk for a single request
  (`api.Runner.make_paged_prefill`).  Slot membership, lengths and page
  bindings are data (fixed-shape int32/bool arrays).
* **Paged device KV.**  KV lives in slot-agnostic pools indexed by
  per-slot page tables; `segment_cache.PageAllocator` owns the pages.
  The steps update the pools in place.
* **The scheduler.**  FCFS admission into free slots; each tick runs at
  most one prefill chunk (the oldest admitted request with unprefilled
  prompt) and then one decode tick over every decode-ready slot.  On pool
  exhaustion the youngest admitted request is preempted (pages freed,
  request requeued at the queue head) and on re-admission re-prefills
  its prompt plus its emitted tokens, so preemption never changes the
  output stream.
* **The radix prefix cache** (`radix_cache=True`, the default): matching
  KV pages attach at admission by content; full pages publish into the
  trie when prefill completes, on release and on preemption.

This slice serves greedily.  Sampling, speculative decoding, the other
scheduler policies, the bounded queue, tenant budgets, SLO shedding and
telemetry are later slices: asking for any of them raises
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving.segment_cache import PageAllocator

_LATER = {
    "temperature": "sampling (threefry key schedule)",
    "spec_k": "speculative decoding",
    "policy": "scheduler policies",
    "max_queue": "the bounded admission queue",
    "tenant_budgets": "tenant budgets",
    "slo": "SLO-aware shedding",
}


def _not_yet(knob: str):
    raise NotImplementedError(f"{knob} is not ported yet: it arrives with "
                              f"the {_LATER[knob]} slice")


@dataclasses.dataclass
class OnlineConfig:
    """Engine geometry.  `max_context` bounds prompt+generation per
    request; `n_pages` sizes the shared pool (default: every slot can
    hold a full context, +1 scratch page — shrink it to exercise
    preemption).  The sampling / speculation / policy fields keep the
    reference's names and defaults; any other value raises."""
    max_slots: int
    max_context: int
    page_size: int = 16
    n_pages: Optional[int] = None
    prefill_chunk: int = 8
    eos_id: Optional[int] = None
    temperature: float = 0.0
    spec_k: int = 0
    radix_cache: bool = True
    policy: str = "fcfs"
    max_queue: Optional[int] = None
    tenant_budgets: Optional[Dict[str, int]] = None
    slo: Optional[Any] = None

    def __post_init__(self):
        if self.temperature > 0.0:
            _not_yet("temperature")
        if self.spec_k > 0:
            _not_yet("spec_k")
        if self.policy != "fcfs":
            _not_yet("policy")
        for knob in ("max_queue", "tenant_budgets", "slo"):
            if getattr(self, knob) is not None:
                _not_yet(knob)

    @property
    def max_pages(self) -> int:
        return -(-self.max_context // self.page_size)

    def pool_pages(self) -> int:
        if self.n_pages is not None:
            return self.n_pages
        return self.max_slots * self.max_pages + 1


@dataclasses.dataclass
class OnlineRequest:
    rid: int
    prompt: np.ndarray
    max_new: int
    arrival_t: float = 0.0
    temperature: Optional[float] = None
    out: List[int] = dataclasses.field(default_factory=list)
    state: str = "queued"            # queued | prefill | decode | done
    first_token_t: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    n_decode_ticks: int = 0
    # scheduler scratch (valid while the request holds a slot)
    fed: Optional[np.ndarray] = None   # tokens to prefill (prompt + out[:-1])
    prefill_pos: int = 0

    @property
    def done(self) -> bool:
        return self.state == "done"


class OnlineEngine:
    """Continuous-batching scheduler around the fixed-shape paged steps.
    `step_calls` counts prefill chunks and decode ticks run."""

    def __init__(self, runner, params, cfg: OnlineConfig):
        M.check_paged_support(runner.cfg)
        n_pages = cfg.pool_pages()
        if n_pages - 1 < cfg.max_pages:
            raise ValueError(
                f"pool of {n_pages} pages (1 reserved) cannot hold even "
                f"one max_context={cfg.max_context} request "
                f"({cfg.max_pages} pages)")
        self.cfg = cfg
        self.runner = runner
        self.params = params
        self.device = runner.device
        self.paged_attn = L.resolve_paged_attn(runner.flags.paged_attn)
        self.alloc = PageAllocator(n_pages, cfg.page_size)
        self.pools = runner.init_paged_pools(n_pages, cfg.page_size)
        self._decode = runner.make_paged_decode_step(cfg.page_size)
        self._prefill = runner.make_paged_prefill(cfg.page_size)

        S = cfg.max_slots
        self.slot_rid = np.full((S,), -1, np.int64)
        self.table = np.zeros((S, cfg.max_pages), np.int32)
        self.lens = np.zeros((S,), np.int32)
        self.active = np.zeros((S,), bool)
        self.tok = np.zeros((S,), np.int32)
        self.slot_seq = np.zeros((S,), np.int64)   # admission counter
        self._seq = 0

        self.queue: Deque[int] = deque()
        self.reqs: Dict[int, OnlineRequest] = {}
        self.admission_log: List[int] = []
        self.ticks = 0
        self.n_preemptions = 0
        self.step_calls = {"prefill": 0, "decode": 0}

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- submission -----------------------------------------------------------
    def submit(self, req: OnlineRequest) -> bool:
        """Enqueue a request (always accepted: the queue is unbounded)."""
        total = len(req.prompt) + req.max_new
        if total > self.cfg.max_context:
            raise ValueError(f"request {req.rid}: prompt+max_new={total} "
                             f"exceeds max_context={self.cfg.max_context}")
        if req.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if len(req.prompt) < 1:
            raise ValueError("prompt must hold at least one token")
        if req.temperature is not None and req.temperature > 0.0:
            _not_yet("temperature")
        old = self.reqs.get(req.rid)
        if old is not None and not old.done:
            raise ValueError(f"rid {req.rid} is still in flight "
                             f"(state={old.state}); rids must be unique "
                             f"among live requests")
        if req.arrival_t <= 0.0:
            req.arrival_t = time.perf_counter()
        self.reqs[req.rid] = req
        self.queue.append(req.rid)
        return True

    def submit_many(self, reqs: Sequence[OnlineRequest]):
        for r in reqs:
            self.submit(r)

    # -- scheduling helpers ---------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [int(s) for s in np.flatnonzero(self.slot_rid < 0)]

    def _busy_slots(self) -> List[int]:
        return [int(s) for s in np.flatnonzero(self.slot_rid >= 0)]

    def _admit(self):
        for slot in self._free_slots():
            if not self.queue:
                break
            rid = self.queue.popleft()
            r = self.reqs[rid]
            # re-prefill prompt + already-emitted tokens minus the last,
            # which becomes the next decode input (never re-sampled)
            r.fed = (np.concatenate([r.prompt,
                                     np.asarray(r.out[:-1], np.int32)])
                     if r.out else np.asarray(r.prompt, np.int32)
                     ).astype(np.int32)
            shared = self.alloc.admit(
                rid, tokens=r.fed if self.cfg.radix_cache else None)
            r.prefill_pos = min(shared, max(len(r.fed) - 1, 0))
            r.state = "prefill"
            self.slot_rid[slot] = rid
            self.slot_seq[slot] = self._seq
            self._seq += 1
            self.table[slot] = self.alloc.table_row(rid, self.cfg.max_pages)
            self.lens[slot] = 0
            self.active[slot] = False
            self.tok[slot] = 0
            self.admission_log.append(rid)

    def _clear_slot(self, slot: int):
        self.slot_rid[slot] = -1
        self.table[slot] = 0
        self.lens[slot] = 0
        self.active[slot] = False
        self.tok[slot] = 0

    def _written_tokens(self, slot: int) -> np.ndarray:
        """The token each written KV row holds, in row order (during
        prefill only `prefill_pos` rows are written)."""
        r = self.reqs[int(self.slot_rid[slot])]
        written = (r.prefill_pos if r.state == "prefill"
                   else int(self.lens[slot]))
        seq = (np.concatenate([r.prompt, np.asarray(r.out, np.int32)])
               if r.out else np.asarray(r.prompt, np.int32))
        return seq[:written].astype(np.int32)

    def _finish(self, slot: int):
        rid = int(self.slot_rid[slot])
        r = self.reqs[rid]
        if self.cfg.radix_cache:
            self.alloc.release(rid, tokens=self._written_tokens(slot))
        else:
            self.alloc.release(rid)
        r.state = "done"
        r.fed = None
        self._clear_slot(slot)

    def _preempt_slot(self, slot: int):
        """Free a victim's pages and requeue it at the queue head (its
        full pages are published first when the radix cache is on)."""
        rid = int(self.slot_rid[slot])
        r = self.reqs[rid]
        if self.cfg.radix_cache:
            self.alloc.preempt(rid, tokens=self._written_tokens(slot))
        else:
            self.alloc.preempt(rid)
        r.state = "queued"
        r.fed = None
        self.queue.appendleft(rid)
        self._clear_slot(slot)
        self.n_preemptions += 1

    def _make_room(self, rid: int, n_tokens: int):
        """ensure_capacity with preempt-and-requeue: evict the youngest
        other resident until the grow fits; raise when the request is
        the sole resident and still cannot fit."""
        while not self.alloc.ensure_capacity(rid, n_tokens):
            victims = [s for s in self._busy_slots()
                       if int(self.slot_rid[s]) != rid]
            if not victims:
                raise RuntimeError(
                    f"request {rid} needs {n_tokens} tokens "
                    f"({-(-n_tokens // self.cfg.page_size)} pages) but the "
                    f"pool cannot satisfy it even empty: {self.alloc.n_free}"
                    f" free")
            self._preempt_slot(max(victims, key=lambda s: self.slot_seq[s]))

    # -- prefill --------------------------------------------------------------
    def _prefill_target(self) -> Optional[int]:
        """Oldest admitted slot with unprefilled tokens."""
        cands = [s for s in self._busy_slots()
                 if self.reqs[int(self.slot_rid[s])].state == "prefill"]
        if not cands:
            return None
        return min(cands, key=lambda s: self.slot_seq[s])

    def _prefill_tick(self):
        """Run one prefill chunk for the oldest prefilling slot."""
        slot = self._prefill_target()
        if slot is None:
            return
        rid = int(self.slot_rid[slot])
        r = self.reqs[rid]
        C = self.cfg.prefill_chunk
        n_valid = min(C, len(r.fed) - r.prefill_pos)
        self._make_room(rid, r.prefill_pos + n_valid)
        self.table[slot] = self.alloc.table_row(rid, self.cfg.max_pages)
        chunk = np.zeros((C,), np.int32)
        chunk[:n_valid] = r.fed[r.prefill_pos:r.prefill_pos + n_valid]
        nxt, self.pools = self._prefill(
            self.params, self.pools, self._dev(chunk), r.prefill_pos,
            n_valid, self._dev(self.table[slot]))
        self.step_calls["prefill"] += 1
        r.prefill_pos += n_valid
        if r.prefill_pos < len(r.fed):
            return                      # more chunks to go
        # prompt (+ replayed tokens) fully written: enter decode state
        t = time.perf_counter()
        self.lens[slot] = len(r.fed)
        self.active[slot] = True
        r.state = "decode"
        if self.cfg.radix_cache:
            self.alloc.publish_radix(rid, r.fed)
        if not r.out:
            tok = int(nxt)      # one device->host read per finished prefill
            r.out.append(tok)
            r.first_token_t = t
            r.token_times.append(t)
            if len(r.out) >= r.max_new or tok == self.cfg.eos_id:
                self._finish(slot)
                return
        self.tok[slot] = r.out[-1]

    # -- decode ---------------------------------------------------------------
    def _decode_tick(self):
        # grow every decode slot to hold its next position, oldest first
        # (the youngest is the preferred victim, so growing in age order
        # never evicts a slot already grown this tick)
        for slot in sorted(np.flatnonzero(self.active),
                           key=lambda s: self.slot_seq[s]):
            slot = int(slot)
            if not self.active[slot]:
                continue                # preempted by an earlier grow
            rid = int(self.slot_rid[slot])
            self._make_room(rid, int(self.lens[slot]) + 1)
            self.table[slot] = self.alloc.table_row(rid, self.cfg.max_pages)
        if not self.active.any():
            return
        nxt, self.pools = self._decode(
            self.params, self.pools, self._dev(self.tok),
            self._dev(self.lens), self._dev(self.table),
            self._dev(self.active))
        self.step_calls["decode"] += 1
        nxt = nxt.cpu().numpy()         # the tick's one device->host drain
        t = time.perf_counter()
        for slot in np.flatnonzero(self.active):
            slot = int(slot)
            r = self.reqs[int(self.slot_rid[slot])]
            # nxt is host data since the drain above
            tok = int(nxt[slot])  # flopcheck: disable=FC-HOSTSYNC
            r.out.append(tok)
            r.token_times.append(t)
            r.n_decode_ticks += 1
            self.lens[slot] += 1
            self.tok[slot] = tok
            if len(r.out) >= r.max_new or tok == self.cfg.eos_id:
                self._finish(slot)

    def pop_done(self) -> List[OnlineRequest]:
        """Remove and return finished requests."""
        done = [r for r in self.reqs.values() if r.done]
        for r in done:
            del self.reqs[r.rid]
        return done

    # -- the tick loop --------------------------------------------------------
    @property
    def idle(self) -> bool:
        return not self.queue and not self._busy_slots()

    def tick(self):
        """One engine step: admission -> one prefill chunk -> one decode
        tick over every decode-ready slot."""
        self.ticks += 1
        self._admit()
        self._prefill_tick()
        self._decode_tick()

    def run(self, max_ticks: int = 100_000):
        """Drive ticks until every submitted request is done."""
        for _ in range(max_ticks):
            if self.idle:
                return
            self.tick()
        raise RuntimeError(f"engine did not drain in {max_ticks} ticks "
                           f"(queue={len(self.queue)}, "
                           f"busy={self._busy_slots()})")


# ---------------------------------------------------------------------------
# Poisson load generator
# ---------------------------------------------------------------------------


def _pctl(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def run_poisson_load(engine: OnlineEngine, *, rate: float, n_requests: int,
                     prompt_len: Union[int, Tuple[int, int]], max_new: int,
                     vocab_size: int, seed: int = 0,
                     max_ticks: int = 1_000_000) -> Dict[str, Any]:
    """Open-loop Poisson arrivals at `rate` req/s against a live engine.

    Requests are submitted when their scheduled arrival time passes on
    the wall clock (the engine keeps ticking in between), so TTFT
    includes queueing delay.  Returns TTFT p50/p99, pooled inter-token
    latency p50/p99, sustained tok/s and churn counters.  With an int
    `prompt_len` the prompts are drawn exactly as the reference's load
    generator draws them; a (lo, hi) pair draws each prompt's length
    uniformly from [lo, hi] after that.  The radix cache is flushed
    before returning, so repeated loads start cold."""
    rs = np.random.RandomState(seed)
    gaps = rs.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    if isinstance(prompt_len, int):
        prompts = [rs.randint(0, vocab_size, prompt_len).astype(np.int32)
                   for _ in range(n_requests)]
    else:
        lo, hi = prompt_len
        prompts = [rs.randint(0, vocab_size, n).astype(np.int32)
                   for n in rs.randint(lo, hi + 1, size=n_requests)]
    base = (max(engine.reqs) + 1) if engine.reqs else 0   # engine reuse
    ticks0, preempts0 = engine.ticks, engine.n_preemptions
    hits0 = engine.alloc.stats["prefix_hits"]
    hit_tok0 = engine.alloc.stats["radix_hit_tokens"]
    evict0 = engine.alloc.stats["evictions"]
    reqs = [OnlineRequest(rid=base + i, prompt=prompts[i], max_new=max_new)
            for i in range(n_requests)]
    t0 = time.perf_counter()
    submitted = 0
    budget = max_ticks
    while submitted < n_requests or not engine.idle:
        budget -= 1
        if budget < 0:
            raise RuntimeError(f"load run did not drain in {max_ticks} "
                               f"ticks ({submitted}/{n_requests} submitted)")
        now = time.perf_counter()
        while (submitted < n_requests
               and arrivals[submitted] <= now - t0):
            r = reqs[submitted]
            r.arrival_t = t0 + arrivals[submitted]
            engine.submit(r)
            submitted += 1
        if engine.idle and submitted < n_requests:
            time.sleep(min(arrivals[submitted] - (now - t0), 0.01))
            continue
        engine.tick()
    t_end = time.perf_counter()

    assert all(r.done for r in reqs)
    engine.pop_done()              # keep the engine bounded across loads
    engine.alloc.flush_radix()     # repeated loads start cache-cold
    ttft = [r.first_token_t - r.arrival_t for r in reqs]
    itl: List[float] = []
    for r in reqs:
        itl.extend(b - a for a, b in zip(r.token_times, r.token_times[1:]))
    n_tokens = sum(len(r.out) for r in reqs)
    decode_ticks = sum(r.n_decode_ticks for r in reqs)
    decoded = sum(max(len(r.out) - 1, 0) for r in reqs)
    return {
        "rate_req_s": rate,
        "n_requests": n_requests,
        "prompt_len": [len(p) for p in prompts],
        "max_new": max_new,
        "radix_cache": engine.cfg.radix_cache,
        "paged_attn": engine.paged_attn,
        "wall_s": t_end - t0,
        "tokens_out": n_tokens,
        "tok_s": n_tokens / max(t_end - t0, 1e-9),
        "ttft_p50_ms": 1e3 * _pctl(ttft, 50),
        "ttft_p99_ms": 1e3 * _pctl(ttft, 99),
        "itl_p50_ms": 1e3 * _pctl(itl, 50),
        "itl_p99_ms": 1e3 * _pctl(itl, 99),
        "ticks": engine.ticks - ticks0,
        "preemptions": engine.n_preemptions - preempts0,
        "decode_ticks_per_token": decode_ticks / max(decoded, 1),
        "prefix_hits": engine.alloc.stats["prefix_hits"] - hits0,
        "prefix_hit_rate": (engine.alloc.stats["prefix_hits"] - hits0)
        / max(n_requests, 1),
        "prefix_hit_tokens": (engine.alloc.stats["radix_hit_tokens"]
                              - hit_tok0),
        "cache_evictions": engine.alloc.stats["evictions"] - evict0,
        "allocator": dict(engine.alloc.stats),
    }
