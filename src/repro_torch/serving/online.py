"""Online continuous-batching serving engine over a paged device KV cache
(counterpart of `repro.serving.online`).

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
  output stream.  A policy layer rides on top: `policy` picks the tick
  order ("fcfs" | "decode-priority" | "prefill-priority", see `tick`),
  `max_queue` + `overload` bound the queue (shed or defer), and
  `tenant_budgets` caps each tenant's admitted tokens; all of it host
  bookkeeping over the same steps.
* **Sampling.**  Per-slot temperature / top-p / top-k / seed are (B,)
  data to the steps, which always sample: draws use the (seed, position,
  stream) key schedule of `models.embedding`, so streams survive
  preemption replay and temperature 0 is the greedy token bit for bit.
* **Speculative decoding** (`spec_k > 0` and a `serving.draft` drafter).
  Each spec tick the drafter proposes k tokens per slot over its own
  pools (the target's page ids), one target pass shaped like a k+1-row
  prefill scores every candidate, and the host commits `n_acc + 1`
  tokens a slot, `PageAllocator.trim` handing rejected tail pages back
  (LIFO, so a regrow takes the same pages).  Greedy streams equal the
  non-speculative ones; acceptance only changes ticks per token.
* **The radix prefix cache** (`radix_cache=True`, the default): matching
  KV pages attach at admission by content; full pages publish into the
  trie when prefill completes, on release and on preemption.
* **Telemetry**: every engine owns a `telemetry.MetricsRegistry`
  (TTFT/ITL/tick histograms, churn counters, occupancy gauges and
  per-tick counter-track series), a `telemetry.RequestLog` of each
  request's lifecycle (enqueue -> admit -> prefill chunks -> first token
  -> decode -> preempt/requeue -> complete/shed, with ticks and
  timestamps) and an `XPUTimer` spanning the scheduler phases of every
  tick, exportable to Perfetto with `telemetry.write_chrome_trace`.  All
  of it reads host scalars the scheduler already holds: it adds no
  device-to-host read.  `overload="slo"` closes the loop: a
  `telemetry.SLOTracker` over the windowed histograms sheds a request at
  submit time when admitting it would breach the configured TTFT/ITL p99
  deadlines.
* **A (1, tp) mesh** (a runner built on one): every rank runs this same
  host scheduler over the same requests, in lockstep.  Each decision
  comes from host state and from the steps' tokens, which are equal on
  every rank, so no rank can diverge (a divergence would hang a
  collective; the mesh's groups carry a timeout).  `max_slots` and
  `prefill_chunk` must divide over tp (the "ep" dispatch's batch); the
  Poisson load agrees its clock across ranks (`Mesh.agree`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis import contracts
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving.flood import quantize_microbatch
from repro_torch.serving.segment_cache import PageAllocator
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.request_log import RequestLog
from repro_torch.telemetry.slo import SLOConfig, SLOTracker
from repro_torch.telemetry.xputimer import XPUTimer

POLICIES = ("fcfs", "decode-priority", "prefill-priority")
OVERLOAD = ("defer", "shed", "slo")


@dataclasses.dataclass
class OnlineConfig:
    """Engine geometry and the default sampling / speculation knobs.
    `max_context` bounds prompt+generation per request; `n_pages` sizes
    the shared pool (default: every slot can hold a full context, +1
    scratch page; shrink it to exercise preemption).  The sampling fields
    are per-request defaults (an `OnlineRequest` may override each);
    temperature 0 is exact greedy, and a request's seed defaults to
    (seed + rid) % 2**31.  `spec_k > 0` turns on speculative decoding (a
    drafter is then required) and adds spec_k positions of page-table
    slack, since the verify pass writes k+1 candidate rows before the
    host commits.  `policy`, `max_queue` + `overload` ("defer" | "shed"
    | "slo") and `tenant_budgets` (admitted prompt+max_new tokens per
    tenant) are host bookkeeping.  `overload="slo"` sheds at submit time
    when the `slo` deadlines (a `telemetry.SLOConfig`) would be breached;
    `trace_ring` sizes the request lifecycle log.  `debug_guards` runs
    every tick under `analysis.contracts.transfer_guard` (None: the
    REPRO_DEBUG_GUARDS env var), so a device->host sync other than the
    tick's announced drains raises on a card."""
    max_slots: int
    max_context: int
    page_size: int = 16
    n_pages: Optional[int] = None
    prefill_chunk: int = 8
    eos_id: Optional[int] = None
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0
    spec_k: int = 0
    radix_cache: bool = True
    policy: str = "fcfs"
    max_queue: Optional[int] = None
    overload: str = "defer"
    tenant_budgets: Optional[Dict[str, int]] = None
    slo: Optional[SLOConfig] = None
    trace_ring: int = 65536
    debug_guards: Optional[bool] = None

    @property
    def max_pages(self) -> int:
        return -(-(self.max_context + self.spec_k) // self.page_size)

    def pool_pages(self) -> int:
        if self.n_pages is not None:
            return self.n_pages
        return self.max_slots * self.max_pages + 1


@dataclasses.dataclass
class OnlineRequest:
    rid: int
    prompt: np.ndarray
    max_new: int
    prefix_key: Optional[str] = None
    prefix_len: int = 0              # tokens to auto-publish under prefix_key
    tenant: Optional[str] = None     # admission-budget accounting key
    arrival_t: float = 0.0
    # sampling overrides (None: the OnlineConfig default); the seed is
    # fixed per request, so preemption replay re-derives the same draws
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    seed: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    state: str = "queued"            # queued | prefill | decode | done | shed
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    n_preempted: int = 0
    n_decode_ticks: int = 0          # decode or spec ticks this slot rode
    # scheduler scratch (valid while the request holds a slot)
    fed: Optional[np.ndarray] = None   # tokens to prefill (prompt + out[:-1])
    prefill_pos: int = 0

    @property
    def done(self) -> bool:
        return self.state == "done"


class OnlineEngine:
    """Continuous-batching scheduler around the fixed-shape paged steps.
    `step_calls` counts the steps run (prefill chunks, decode ticks, and
    in spec mode draft and verify passes).  `registry`, `request_log` and
    `timer` default to fresh ones; `registry`, `rlog` and `timer` hold
    them."""

    def __init__(self, runner, params, cfg: OnlineConfig, drafter=None,
                 registry: Optional[MetricsRegistry] = None,
                 request_log: Optional[RequestLog] = None,
                 timer: Optional[XPUTimer] = None):
        M.check_paged_support(runner.cfg)
        env = runner.env
        tp = env.tp
        if env.dp != 1:
            raise ValueError(f"online serving runs on a (1, tp) mesh; "
                             f"got dp={env.dp}")
        for name in ("max_slots", "prefill_chunk"):
            n = getattr(cfg, name)
            if quantize_microbatch(n, tp) != n:
                raise ValueError(
                    f"{name}={n} violates the EP batch constraint ({name} "
                    f"% tp == 0 for tp={tp}); round up with "
                    f"serving.flood.quantize_microbatch({n}, {tp}) = "
                    f"{quantize_microbatch(n, tp)}")
        if tp > 1 and (cfg.spec_k > 0 or cfg.overload == "slo"):
            raise NotImplementedError(
                "speculative decoding and the SLO gate (rank-local clocks) "
                "on a tp mesh are not yet ported (ROADMAP item 9)")
        n_pages = cfg.pool_pages()
        if n_pages - 1 < cfg.max_pages:
            raise ValueError(
                f"pool of {n_pages} pages (1 reserved) cannot hold even "
                f"one max_context={cfg.max_context} request "
                f"({cfg.max_pages} pages)")
        if cfg.policy not in POLICIES:
            raise ValueError(f"policy={cfg.policy!r} not in {POLICIES}")
        if cfg.overload not in OVERLOAD:
            raise ValueError(f"overload={cfg.overload!r} not in {OVERLOAD}")
        if cfg.max_queue is not None and cfg.max_queue < 1:
            raise ValueError(f"max_queue={cfg.max_queue} must be >= 1")
        if cfg.overload == "slo" and cfg.slo is None:
            raise ValueError(
                'overload="slo" needs deadlines: set OnlineConfig.slo to a '
                "telemetry.SLOConfig(ttft_p99_ms=...)")
        self.cfg = cfg
        self.runner = runner
        self.params = params
        self.device = runner.device
        self.debug_guards = (contracts.env_debug_guards()
                             if cfg.debug_guards is None
                             else cfg.debug_guards)
        self.paged_attn = L.resolve_paged_attn(runner.flags.paged_attn)
        self.alloc = PageAllocator(n_pages, cfg.page_size)
        self.pools = runner.init_paged_pools(n_pages, cfg.page_size)

        # speculative decoding: the drafter's own pools, with the target's
        # page ids, page size and pool count
        self.spec = cfg.spec_k > 0
        self.dparams = self.dpools = None
        if self.spec:
            if drafter is None:
                raise ValueError(
                    f"spec_k={cfg.spec_k} > 0 requires a drafter (e.g. "
                    f"serving.draft.SelfDrafter(draft_layers=...))")
            drunner, self.dparams = drafter.build(runner, params)
            if drunner.cfg.vocab_size != runner.cfg.vocab_size:
                raise ValueError(
                    f"drafter vocab_size={drunner.cfg.vocab_size} != "
                    f"target vocab_size={runner.cfg.vocab_size}")
            self.dpools = drunner.init_paged_pools(n_pages, cfg.page_size)
            self._dprefill = drunner.make_paged_prefill(cfg.page_size)
            self._draft = drunner.make_paged_draft_propose(cfg.page_size,
                                                           cfg.spec_k)
            self._verify = runner.make_paged_verify_step(cfg.page_size,
                                                         cfg.spec_k)
        self.spec_proposed = 0        # drafted tokens offered to verify
        self.spec_accepted = 0        # drafted tokens accepted
        # the steps always sample: the knobs are (B,) data and temperature
        # 0 is the greedy token bit for bit
        self._decode = runner.make_paged_decode_step(cfg.page_size,
                                                     sample=True)
        self._prefill = runner.make_paged_prefill(cfg.page_size, sample=True)

        S = cfg.max_slots
        self.slot_rid = np.full((S,), -1, np.int64)
        self.table = np.zeros((S, cfg.max_pages), np.int32)
        self.lens = np.zeros((S,), np.int32)
        self.active = np.zeros((S,), bool)
        self.tok = np.zeros((S,), np.int32)
        self.slot_seq = np.zeros((S,), np.int64)   # admission counter
        self._seq = 0
        # per-slot sampling knobs, data to the steps
        self.seeds = np.zeros((S,), np.int64)
        self.temps = np.zeros((S,), np.float32)
        self.topps = np.ones((S,), np.float32)
        self.topks = np.zeros((S,), np.int64)

        self.queue: Deque[int] = deque()
        self.reqs: Dict[int, OnlineRequest] = {}
        self.admission_log: List[int] = []
        self.ticks = 0
        self.n_preemptions = 0
        self.policy = cfg.policy
        self.n_shed = 0                  # saturation-gate rejections
        self.n_budget_skips = 0          # admissions deferred over budget
        self.step_calls = {"prefill": 0, "decode": 0, "draft": 0,
                           "verify": 0}

        # -- telemetry: host scalars the scheduler already holds ----------
        self.registry = registry if registry is not None else MetricsRegistry()
        self.rlog = (request_log if request_log is not None
                     else RequestLog(cfg.trace_ring))
        self.timer = (timer if timer is not None
                      else XPUTimer(registry=self.registry))
        if self.timer.registry is None:
            self.timer.registry = self.registry
        # the SLOTracker first: it sizes the shared latency histograms'
        # windows (get-or-create below then returns the same children)
        self.slo = (SLOTracker(cfg.slo, self.registry)
                    if cfg.slo is not None else None)
        reg = self.registry
        self._m_ttft = reg.histogram(
            "serve_ttft_ms", "time to first token (admitted requests)")
        self._m_itl = reg.histogram(
            "serve_itl_ms", "inter-token latency (decode steps)")
        self._m_tick = reg.histogram(
            "serve_tick_ms", "engine tick wall time")
        self._m_enq = reg.counter(
            "serve_enqueued_total", "requests accepted into the queue")
        self._m_admit = reg.counter(
            "serve_admitted_total", "requests bound to a slot")
        self._m_done = reg.counter(
            "serve_completed_total", "requests finished")
        self._m_shed = reg.counter(
            "serve_shed_total", "requests rejected by the admission gate")
        self._m_preempt = reg.counter(
            "serve_preemptions_total", "slot preempt-and-requeue events")
        self._m_tokens = reg.counter(
            "serve_tokens_total", "tokens emitted across all requests")
        self._m_evict = reg.counter(
            "serve_cache_evictions_total", "radix-cache pages evicted")
        self._g_queue = reg.gauge("serve_queue_depth", "arrival queue depth")
        self._g_pages = reg.gauge(
            "serve_pages_in_use", "KV pool pages held (requests+cache)")
        self._g_slots = reg.gauge("serve_slots_active", "occupied slots")
        # per-tick samples -> Perfetto counter tracks (trace_export)
        self._s_pages = reg.series("page_pool_occupancy")
        self._s_queue = reg.series("queue_depth")
        self._s_radix = reg.series("radix_hit_rate")
        self._s_accept = reg.series("spec_acceptance") if self.spec else None
        self._admitted_tokens = 0        # prefill tokens ever admitted
        self.alloc.on_evict = self._on_evict

    def _on_evict(self, page: int):
        """PageAllocator hook: one radix-cache page evicted."""
        self._m_evict.inc()
        self.rlog.record("evict", -1, tick=self.ticks, arg=page)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """Host scheduler state -> the device.  On a card the copy goes
        through pinned memory without waiting (a copy from pageable
        memory waits for the card); `a` may change as soon as this
        returns."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def set_policy(self, policy: str):
        """Switch the tick-ordering policy at run time (host state only)."""
        if policy not in POLICIES:
            raise ValueError(f"policy={policy!r} not in {POLICIES}")
        self.policy = policy

    # -- submission -----------------------------------------------------------
    def submit(self, req: OnlineRequest) -> bool:
        """Enqueue a request.  With a bounded queue (`max_queue`) a full
        queue trips the saturation gate: "shed" marks the request shed
        and drops it (counted in `n_shed`), "defer" returns False without
        touching it, for the caller to retry.  With ``overload="slo"`` the
        SLOTracker also sheds whenever its windowed latency view says this
        request could not meet the deadlines (a full queue sheds too).
        Returns True when enqueued."""
        total = len(req.prompt) + req.max_new
        if total > self.cfg.max_context:
            raise ValueError(f"request {req.rid}: prompt+max_new={total} "
                             f"exceeds max_context={self.cfg.max_context}")
        if req.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if len(req.prompt) < 1:
            raise ValueError("prompt must hold at least one token")
        old = self.reqs.get(req.rid)
        if old is not None and not old.done:
            raise ValueError(f"rid {req.rid} is still in flight "
                             f"(state={old.state}); rids must be unique "
                             f"among live requests")
        if req.arrival_t <= 0.0:
            req.arrival_t = time.perf_counter()
        if self.cfg.overload == "slo":
            queued_tokens = (sum(len(self.reqs[q].prompt)
                                 for q in self.queue) + len(req.prompt))
            if self.slo.should_shed(queued_tokens,
                                    self.cfg.prefill_chunk) is not None:
                return self._shed(req)
        if (self.cfg.max_queue is not None
                and len(self.queue) >= self.cfg.max_queue):
            if self.cfg.overload in ("shed", "slo"):
                return self._shed(req)
            return False
        self.reqs[req.rid] = req
        self.queue.append(req.rid)
        self._m_enq.inc()
        self.rlog.record("enqueue", req.rid, tick=self.ticks)
        return True

    def _shed(self, req: OnlineRequest) -> bool:
        req.state = "shed"
        self.n_shed += 1
        self._m_shed.inc()
        if self.slo is not None:
            self.slo.on_shed()
        self.rlog.record("shed", req.rid, tick=self.ticks)
        return False

    def register_prefix(self, rid: int, key: str, n_tokens: int):
        """Publish a live request's leading full pages for prefix reuse;
        later submissions carrying `prefix_key=key` skip prefilling the
        shared tokens (with the radix cache off; their prompt must start
        with the same tokens)."""
        self.alloc.register_prefix(rid, key, n_tokens)

    def submit_many(self, reqs: Sequence[OnlineRequest]):
        for r in reqs:
            if not self.submit(r):
                raise RuntimeError(
                    f"rid {r.rid} rejected by the saturation gate (queue "
                    f"full at max_queue={self.cfg.max_queue}); submit_many "
                    f"is for unbounded batches: use submit and handle its "
                    f"False")

    # -- scheduling helpers ---------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [int(s) for s in np.flatnonzero(self.slot_rid < 0)]

    def _busy_slots(self) -> List[int]:
        return [int(s) for s in np.flatnonzero(self.slot_rid >= 0)]

    def _tenant_usage(self) -> Dict[str, int]:
        usage: Dict[str, int] = {}
        for s in self._busy_slots():
            r = self.reqs[int(self.slot_rid[s])]
            if r.tenant is not None:
                usage[r.tenant] = (usage.get(r.tenant, 0)
                                   + len(r.prompt) + r.max_new)
        return usage

    def _next_admissible(self, budgets, usage, skipped) -> Optional[int]:
        """Pop the first queued rid whose tenant has budget left; the ones
        over budget go to `skipped` (FCFS order kept)."""
        while self.queue:
            cand = self.queue.popleft()
            c = self.reqs[cand]
            budget = budgets.get(c.tenant) if c.tenant is not None else None
            if (budget is not None and usage.get(c.tenant, 0)
                    + len(c.prompt) + c.max_new > budget):
                skipped.append(cand)
                self.n_budget_skips += 1
                continue
            return cand
        return None

    def _admit(self, now: float):
        budgets = self.cfg.tenant_budgets or {}
        usage = self._tenant_usage() if budgets else {}
        skipped: List[int] = []
        for slot in self._free_slots():
            rid = self._next_admissible(budgets, usage, skipped)
            if rid is None:
                break
            r = self.reqs[rid]
            if r.tenant is not None and budgets:
                usage[r.tenant] = (usage.get(r.tenant, 0)
                                   + len(r.prompt) + r.max_new)
            # re-prefill prompt + already-emitted tokens minus the last,
            # which becomes the next decode input (never re-sampled)
            r.fed = (np.concatenate([r.prompt,
                                     np.asarray(r.out[:-1], np.int32)])
                     if r.out else np.asarray(r.prompt, np.int32)
                     ).astype(np.int32)
            if self.cfg.radix_cache:
                shared = self.alloc.admit(rid, tokens=r.fed)
            else:
                # the keyed attach, capped at the original prompt: shared
                # pages must never receive this request's writes
                shared = self.alloc.admit(rid, prefix_key=r.prefix_key,
                                          prompt_len=len(r.prompt))
            r.prefill_pos = min(shared, max(len(r.fed) - 1, 0))
            r.state = "prefill"
            r.admit_t = now
            self.slot_rid[slot] = rid
            self.slot_seq[slot] = self._seq
            self._seq += 1
            self.table[slot] = self.alloc.table_row(rid, self.cfg.max_pages)
            self.lens[slot] = 0
            self.active[slot] = False
            self.tok[slot] = 0
            # the request's knobs, else the engine's defaults; the seed is
            # a function of (cfg.seed, rid), so a preempted request
            # re-derives the same draws
            cfg = self.cfg
            self.seeds[slot] = (r.seed if r.seed is not None
                                else (cfg.seed + rid) % (2 ** 31))
            self.temps[slot] = (r.temperature if r.temperature is not None
                                else cfg.temperature)
            self.topps[slot] = r.top_p if r.top_p is not None else cfg.top_p
            self.topks[slot] = r.top_k if r.top_k is not None else cfg.top_k
            self.admission_log.append(rid)
            self._m_admit.inc()
            self._admitted_tokens += len(r.fed)
            self.rlog.record("admit", rid, slot=slot, tick=self.ticks,
                             arg=len(r.fed))
        # over-budget holds return to the queue head in FCFS order
        for cand in reversed(skipped):
            self.queue.appendleft(cand)

    def _clear_slot(self, slot: int):
        self.slot_rid[slot] = -1
        self.table[slot] = 0
        self.lens[slot] = 0
        self.active[slot] = False
        self.tok[slot] = 0
        self.seeds[slot] = 0
        self.temps[slot] = 0.0
        self.topps[slot] = 1.0
        self.topks[slot] = 0

    def _written_tokens(self, slot: int) -> np.ndarray:
        """The token each written KV row holds, in row order (during
        prefill only `prefill_pos` rows are written; a spec commit grows
        `lens` only over accepted rows)."""
        r = self.reqs[int(self.slot_rid[slot])]
        written = (r.prefill_pos if r.state == "prefill"
                   else int(self.lens[slot]))
        seq = (np.concatenate([r.prompt, np.asarray(r.out, np.int32)])
               if r.out else np.asarray(r.prompt, np.int32))
        return seq[:written].astype(np.int32)

    def _finish(self, slot: int, now: float):
        rid = int(self.slot_rid[slot])
        r = self.reqs[rid]
        if self.cfg.radix_cache:
            self.alloc.release(rid, tokens=self._written_tokens(slot))
        else:
            self.alloc.release(rid)
        r.state = "done"
        r.finish_t = now
        r.fed = None
        self._m_done.inc()
        self.rlog.record("complete", rid, slot=slot, tick=self.ticks,
                         arg=len(r.out))
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
        r.n_preempted += 1
        r.fed = None
        self.queue.appendleft(rid)
        self._clear_slot(slot)
        self.n_preemptions += 1
        self._m_preempt.inc()
        self.rlog.record("preempt", rid, slot=slot, tick=self.ticks)
        self.rlog.record("requeue", rid, tick=self.ticks)

    def _make_room(self, rid: int, n_tokens: int,
                   allow_preempt: bool = True) -> bool:
        """ensure_capacity with preempt-and-requeue: evict the youngest
        other resident until the grow fits; raise when the request is the
        sole resident and still cannot fit.  With `allow_preempt=False`
        (decode-priority prefill) a grow that needs a victim returns
        False instead, and the caller defers."""
        while not self.alloc.ensure_capacity(rid, n_tokens):
            victims = [s for s in self._busy_slots()
                       if int(self.slot_rid[s]) != rid]
            if not victims:
                raise RuntimeError(
                    f"request {rid} needs {n_tokens} tokens "
                    f"({-(-n_tokens // self.cfg.page_size)} pages) but the "
                    f"pool cannot satisfy it even empty: {self.alloc.n_free}"
                    f" free")
            if not allow_preempt:
                return False
            self._preempt_slot(max(victims, key=lambda s: self.slot_seq[s]))
        return True

    # -- prefill --------------------------------------------------------------
    def _prefill_target(self) -> Optional[int]:
        """Oldest admitted slot with unprefilled tokens."""
        cands = [s for s in self._busy_slots()
                 if self.reqs[int(self.slot_rid[s])].state == "prefill"]
        if not cands:
            return None
        return min(cands, key=lambda s: self.slot_seq[s])

    def _prefill_tick(self) -> bool:
        """Run one prefill chunk for the oldest prefilling slot; returns
        True when it made progress (False: nothing to prefill, or the
        grow deferred under decode-priority)."""
        slot = self._prefill_target()
        if slot is None:
            return False
        rid = int(self.slot_rid[slot])
        r = self.reqs[rid]
        C = self.cfg.prefill_chunk
        n_valid = min(C, len(r.fed) - r.prefill_pos)
        # decode-priority: a prefill never takes pages from decoding slots
        if not self._make_room(rid, r.prefill_pos + n_valid,
                               allow_preempt=(self.policy
                                              != "decode-priority")):
            return False
        self.table[slot] = self.alloc.table_row(rid, self.cfg.max_pages)
        chunk = np.zeros((C,), np.int32)
        chunk[:n_valid] = r.fed[r.prefill_pos:r.prefill_pos + n_valid]
        chunk_d, table_d = self._dev(chunk), self._dev(self.table[slot])
        nxt, self.pools = self._prefill(
            self.params, self.pools, chunk_d, r.prefill_pos, n_valid,
            table_d, int(self.seeds[slot]), float(self.temps[slot]),
            float(self.topps[slot]), int(self.topks[slot]))
        self.step_calls["prefill"] += 1
        if self.spec:
            # the same chunk into the drafter's pools (its token unused)
            _, self.dpools = self._dprefill(self.dparams, self.dpools,
                                            chunk_d, r.prefill_pos, n_valid,
                                            table_d)
        r.prefill_pos += n_valid
        self.rlog.record("prefill_chunk", rid, slot=slot, tick=self.ticks,
                         arg=n_valid)
        if r.prefill_pos < len(r.fed):
            return True                 # more chunks to go
        # prompt (+ replayed tokens) fully written: enter decode state
        t = time.perf_counter()
        self.lens[slot] = len(r.fed)
        self.active[slot] = True
        r.state = "decode"
        self.rlog.record("prefill_done", rid, slot=slot, tick=self.ticks,
                         arg=len(r.fed))
        if self.cfg.radix_cache:
            self.alloc.publish_radix(rid, r.fed)
        elif (r.prefix_key and r.prefix_len > 0
                and r.prefix_key not in self.alloc.prefix_index):
            # keyed auto-publish: the first request to finish its prefill
            self.alloc.register_prefix(rid, r.prefix_key,
                                       min(r.prefix_len, len(r.prompt)))
        if not r.out:
            with contracts.announced_drain():
                tok = int(nxt)  # one device->host read per finished prefill
            r.out.append(tok)
            r.first_token_t = t
            r.token_times.append(t)
            self._m_tokens.inc()
            self.rlog.record("first_token", rid, slot=slot, tick=self.ticks)
            if r.arrival_t > 0.0:
                self._m_ttft.observe((t - r.arrival_t) * 1e3)
            if len(r.out) >= r.max_new or tok == self.cfg.eos_id:
                self._finish(slot, t)
                return True
        self.tok[slot] = r.out[-1]
        return True

    # -- decode ---------------------------------------------------------------
    def _grow_active(self, n_ahead: int):
        """Grow every decode slot to hold `n_ahead` more rows, oldest first
        (the youngest is the preferred victim, so growing in age order
        never evicts a slot already grown this tick)."""
        for slot in sorted(np.flatnonzero(self.active),
                           key=lambda s: self.slot_seq[s]):
            slot = int(slot)
            if not self.active[slot]:
                continue                # preempted by an earlier grow
            rid = int(self.slot_rid[slot])
            self._make_room(rid, int(self.lens[slot]) + n_ahead)
            self.table[slot] = self.alloc.table_row(rid, self.cfg.max_pages)

    def _sample_args(self):
        return (self._dev(self.seeds), self._dev(self.temps),
                self._dev(self.topps), self._dev(self.topks))

    def _decode_tick(self):
        self._grow_active(1)
        if not self.active.any():
            return
        nxt, self.pools = self._decode(
            self.params, self.pools, self._dev(self.tok),
            self._dev(self.lens), self._dev(self.table),
            self._dev(self.active), *self._sample_args())
        self.step_calls["decode"] += 1
        with contracts.announced_drain():
            nxt = nxt.cpu().numpy()     # the tick's one device->host drain
        t = time.perf_counter()
        for slot in np.flatnonzero(self.active):
            slot = int(slot)
            rid = int(self.slot_rid[slot])
            r = self.reqs[rid]
            # nxt is host data since the drain above
            tok = int(nxt[slot])  # flopcheck: disable=FC-HOSTSYNC
            if r.token_times:
                self._m_itl.observe((t - r.token_times[-1]) * 1e3)
            r.out.append(tok)
            r.token_times.append(t)
            r.n_decode_ticks += 1
            self.lens[slot] += 1
            self.tok[slot] = tok
            self._m_tokens.inc()
            self.rlog.record("decode", rid, slot=slot, tick=self.ticks,
                             arg=1)
            if len(r.out) >= r.max_new or tok == self.cfg.eos_id:
                self._finish(slot, t)

    # -- speculative decode (propose -> verify -> commit) ----------------------
    def _spec_tick(self):
        """One speculative tick over the slot batch: the drafter proposes
        k tokens per slot, one target verify pass scores all k+1
        positions, and the host commits `n_acc + 1` tokens per slot, the
        page-table tails rewound by `PageAllocator.trim`."""
        K = self.cfg.spec_k
        self._grow_active(K + 1)
        if not self.active.any():
            return
        sample_args = self._sample_args()
        table, active = self._dev(self.table), self._dev(self.active)
        pos0, tok = self._dev(self.lens), self._dev(self.tok)
        drafts, dprobs, self.dpools = self._draft(
            self.dparams, self.dpools, tok, pos0, table, active,
            *sample_args)
        self.step_calls["draft"] += 1
        tokens = torch.cat([tok[:, None], drafts], dim=1)   # (B, k+1)
        n_acc, out, self.pools = self._verify(
            self.params, self.pools, tokens, pos0, table, active, dprobs,
            *sample_args)
        self.step_calls["verify"] += 1
        with contracts.announced_drain():   # the tick's one drain
            n_acc, out = n_acc.cpu().numpy(), out.cpu().numpy()
        t = time.perf_counter()
        for slot in np.flatnonzero(self.active):
            slot = int(slot)
            rid = int(self.slot_rid[slot])
            r = self.reqs[rid]
            na = int(n_acc[slot])  # flopcheck: disable=FC-HOSTSYNC
            self.spec_proposed += K
            self.spec_accepted += na
            r.n_decode_ticks += 1
            if r.token_times:
                self._m_itl.observe((t - r.token_times[-1]) * 1e3)
            # emit the accepted drafts + the residual/bonus token, cut
            # short by max_new / eos as the plain decode path is
            done = False
            kept = 0
            for tok_ in out[slot, :na + 1]:
                tok_ = int(tok_)  # flopcheck: disable=FC-HOSTSYNC
                r.out.append(tok_)
                r.token_times.append(t)
                kept += 1
                if len(r.out) >= r.max_new or tok_ == self.cfg.eos_id:
                    done = True
                    break
            self._m_tokens.inc(kept)
            self.rlog.record("decode", rid, slot=slot, tick=self.ticks,
                             arg=kept)
            if done:
                self._finish(slot, t)
                continue
            # commit: the pending token + na accepted drafts are written KV
            # (kept == na + 1 rows from the old len); the new pending
            # token's KV lands next tick
            self.lens[slot] += kept
            self.tok[slot] = r.out[-1]
            self.alloc.trim(rid, int(self.lens[slot]))
            self.table[slot] = self.alloc.table_row(rid, self.cfg.max_pages)

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

    def tick(self, now: Optional[float] = None):
        """One engine step under the active policy:

        * ``fcfs``: admission -> one prefill chunk -> one decode (or
          speculative) tick.
        * ``decode-priority``: the decode tick first, then at most one
          prefill chunk, whose growth never preempts a decoding slot (it
          defers until decodes release pages).
        * ``prefill-priority``: every pending prefill chunk, preempting
          decoders for room if needed, then the decode tick: the head
          request reaches its first token within a tick of admission.

        All three drive the same steps.  `now` (the caller's clock, for
        admission timestamps) defaults to the present; the tick's phases
        are XPUTimer spans, its wall time a `serve_tick_ms` observation;
        with `debug_guards` the tick runs under `_tick_guard`."""
        now = time.perf_counter() if now is None else now
        self.ticks += 1
        t_start = time.perf_counter()
        step_span = "spec" if self.spec else "decode"
        step = self._spec_tick if self.spec else self._decode_tick
        with self.timer.span("tick"), self._tick_guard():
            with self.timer.span("admit"):
                self._admit(now)
            if self.policy == "decode-priority":
                with self.timer.span(step_span):
                    step()
                with self.timer.span("prefill"):
                    self._prefill_tick()
            elif self.policy == "prefill-priority":
                with self.timer.span("prefill"):
                    while self._prefill_tick():
                        pass
                with self.timer.span(step_span):
                    step()
            else:                            # fcfs
                with self.timer.span("prefill"):
                    self._prefill_tick()
                with self.timer.span(step_span):
                    step()
        self._m_tick.observe((time.perf_counter() - t_start) * 1e3)
        self._sample_counters()

    def _tick_guard(self):
        """debug_guards mode: the whole tick runs under a device->host
        transfer guard; the drains the tick announces
        (`contracts.announced_drain`) are its only syncs."""
        if self.debug_guards:
            return contracts.transfer_guard("disallow")
        return contextlib.nullcontext()

    def _sample_counters(self):
        """Per-tick host-scalar samples -> gauges and Perfetto counter
        tracks: allocator free-list length, queue length, cumulative
        stats, nothing on the device."""
        t_us = int(time.perf_counter() * 1e6)
        in_use = self.alloc.pages_in_use
        self._g_pages.set(in_use)
        self._s_pages.sample(in_use, t_us)
        depth = len(self.queue)
        self._g_queue.set(depth)
        self._s_queue.sample(depth, t_us)
        self._g_slots.set(int((self.slot_rid >= 0).sum()))
        hit_rate = (self.alloc.stats["radix_hit_tokens"]
                    / max(self._admitted_tokens, 1))
        self._s_radix.sample(hit_rate, t_us)
        if self._s_accept is not None:
            self._s_accept.sample(
                self.spec_accepted / max(self.spec_proposed, 1), t_us)

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
                     max_ticks: int = 1_000_000,
                     shared_prefix_len: int = 0,
                     prefix_key: Optional[str] = None,
                     tenants: Optional[Sequence[str]] = None
                     ) -> Dict[str, Any]:
    """Open-loop Poisson arrivals at `rate` req/s against a live engine.

    Requests are submitted when their scheduled arrival time passes on
    the wall clock (the engine keeps ticking in between), so TTFT
    includes queueing delay.  Returns TTFT p50/p99, pooled inter-token
    latency p50/p99, sustained tok/s, churn counters, spec acceptance,
    and each request's prompt and output tokens (empty when shed).
    With an int `prompt_len` the prompts are drawn exactly as the
    reference's load generator draws them; a (lo, hi) pair draws each
    prompt's length uniformly from [lo, hi] after that.  With an int
    `prompt_len` and ``shared_prefix_len > 0`` every prompt starts with
    the same `shared_prefix_len`-token system prompt (the chat-serving
    hot-prefix shape): the radix cache attaches it by content, and with
    the cache off the keyed prefix registry (`prefix_key`) carries it.  A bounded queue
    may defer (the submission is retried) or shed (the request is
    dropped, as is one the SLO gate refuses); `tenants` are dealt to the
    requests round robin.  The radix
    cache is flushed before returning, so repeated loads start cold."""
    rs = np.random.RandomState(seed)
    gaps = rs.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    use_key = False
    if isinstance(prompt_len, int):
        shared_prefix_len = min(shared_prefix_len, prompt_len)
        use_key = shared_prefix_len > 0 and not engine.cfg.radix_cache
        if use_key and prefix_key is None:
            prefix_key = f"poisson-load-{seed}"
        shared = rs.randint(0, vocab_size, shared_prefix_len).astype(np.int32)
        prompts = [np.concatenate([shared, rs.randint(
            0, vocab_size, prompt_len - shared_prefix_len).astype(np.int32)])
            for _ in range(n_requests)]
    elif shared_prefix_len:
        raise ValueError("shared_prefix_len takes an int prompt_len")
    else:
        lo, hi = prompt_len
        prompts = [rs.randint(0, vocab_size, n).astype(np.int32)
                   for n in rs.randint(lo, hi + 1, size=n_requests)]
    base = (max(engine.reqs) + 1) if engine.reqs else 0   # engine reuse
    ticks0, preempts0 = engine.ticks, engine.n_preemptions
    hits0 = engine.alloc.stats["prefix_hits"]
    hit_tok0 = engine.alloc.stats["radix_hit_tokens"]
    evict0 = engine.alloc.stats["evictions"]
    shed0, skips0 = engine.n_shed, engine.n_budget_skips
    proposed0, accepted0 = engine.spec_proposed, engine.spec_accepted
    reqs = [OnlineRequest(rid=base + i, prompt=prompts[i], max_new=max_new,
                          prefix_key=(prefix_key if use_key else None),
                          prefix_len=(shared_prefix_len if use_key else 0),
                          tenant=(tenants[i % len(tenants)] if tenants
                                  else None))
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
        # over a tp mesh every rank admits by rank 0's clock
        now = t0 + engine.runner.env.mesh.agree(now - t0)
        while (submitted < n_requests
               and arrivals[submitted] <= now - t0):
            r = reqs[submitted]
            r.arrival_t = t0 + arrivals[submitted]
            if engine.submit(r) or r.state == "shed":
                submitted += 1
            else:
                break                    # deferred: retry next loop
        if engine.idle and submitted < n_requests:
            time.sleep(min(arrivals[submitted] - (now - t0), 0.01))
            continue
        engine.tick(now)
    t_end = time.perf_counter()

    served = [r for r in reqs if r.state != "shed"]
    assert all(r.done for r in served)
    engine.pop_done()              # keep the engine bounded across loads
    if use_key and prefix_key in engine.alloc.prefix_index:
        engine.alloc.drop_prefix(prefix_key)
    engine.alloc.flush_radix()     # repeated loads start cache-cold
    ttft = [r.first_token_t - r.arrival_t for r in served]
    itl: List[float] = []
    for r in served:
        itl.extend(b - a for a, b in zip(r.token_times, r.token_times[1:]))
    n_tokens = sum(len(r.out) for r in served)
    # the first token rides the prefill, every later one a decode or spec
    # tick: acceptance takes ticks per token below 1
    decode_ticks = sum(r.n_decode_ticks for r in served)
    decoded = sum(max(len(r.out) - 1, 0) for r in served)
    proposed = engine.spec_proposed - proposed0
    return {
        "rate_req_s": rate,
        "n_requests": n_requests,
        "prompt_len": [len(p) for p in prompts],
        "shared_prefix_len": shared_prefix_len,
        "max_new": max_new,
        "policy": engine.policy,
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
        "shed": engine.n_shed - shed0,
        "budget_skips": engine.n_budget_skips - skips0,
        "spec_k": engine.cfg.spec_k,
        "acceptance_rate": ((engine.spec_accepted - accepted0)
                            / max(proposed, 1)),
        "decode_ticks_per_token": decode_ticks / max(decoded, 1),
        "prefix_hits": engine.alloc.stats["prefix_hits"] - hits0,
        "prefix_hit_rate": (engine.alloc.stats["prefix_hits"] - hits0)
        / max(n_requests, 1),
        "prefix_hit_tokens": (engine.alloc.stats["radix_hit_tokens"]
                              - hit_tok0),
        "cache_evictions": engine.alloc.stats["evictions"] - evict0,
        "allocator": dict(engine.alloc.stats),
        "overload": engine.cfg.overload,
        # the SLO gate's windowed view at the end of the run (TTFT above
        # covers admitted requests only, the deadline's population)
        "slo": engine.slo.snapshot() if engine.slo is not None else None,
        "prompts": [p.tolist() for p in prompts],
        "outputs": [list(r.out) for r in reqs],
    }
