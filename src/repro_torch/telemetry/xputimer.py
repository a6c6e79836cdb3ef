"""XPUTimer — lightweight selective tracing + diagnostic engine (§2.1,
C9; own copy of `repro.telemetry.xputimer`).

Tracing of critical spans, pooled pre-allocated event records,
a compressed ring of (span id, start, duration) records, and a
diagnostic engine: O(1) error attribution per span, per-span latency
distributions, straggler detection.  Host spans time the host's side of
a region; `device_span` times the device work a region enqueues with a
pair of `torch.cuda.Event`s, read back only by `collect_device` — which
the trainer calls in its metrics drain, after the host has waited for
the device anyway — so device timing adds no sync to the hot loop.

With a `MetricsRegistry`, every closed span is also published as an
``xputimer_span_ms{span=...}`` histogram observation, and counters and
gauges as ``xputimer_counter_total`` / ``xputimer_gauge``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Any, Deque, Dict, List, Tuple

import numpy as np
import torch

# compressed record: (span_id: u16, t_start_us: u64, dur_us: u32) = 14 bytes
_RECORD_BYTES = 14
# a "full tracing" record keeps name, args/shapes, thread, stack hint, ...
FULL_RECORD_BYTES = 144


@dataclasses.dataclass
class SpanStats:
    count: int = 0
    total_us: float = 0.0
    max_us: float = 0.0
    durations: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=4096))

    def add(self, dur_us: float):
        self.count += 1
        self.total_us += dur_us
        self.max_us = max(self.max_us, dur_us)
        self.durations.append(dur_us)


class EventPool:
    """Reusable pre-allocated event records (paper: 'event pool
    management to reuse pre-allocated CUDA events')."""

    def __init__(self, size: int = 1024):
        self._free: Deque[list] = deque([None, 0.0, 0.0] for _ in range(size))
        self.allocated = size

    def get(self) -> list:
        if self._free:
            return self._free.popleft()
        self.allocated += 1
        return [None, 0.0, 0.0]

    def put(self, ev: list):
        self._free.append(ev)


class XPUTimer:
    """Span tracer: only the span names used are registered."""

    def __init__(self, ring_size: int = 65536, registry=None):
        # optional MetricsRegistry mirror (see module docstring)
        self.registry = registry
        self._reg_hists: Dict[str, Any] = {}
        self._ids: Dict[str, int] = {}
        self._names: List[str] = []
        self.pool = EventPool()
        # compressed ring buffer: fixed dtype, no python objects
        self.ring = np.zeros(ring_size, dtype=[("sid", "u2"),
                                               ("t0", "u8"),
                                               ("dur", "u4")])
        self.head = 0
        self.wrapped = False
        self.stats: Dict[str, SpanStats] = defaultdict(SpanStats)
        self.counters: Dict[str, int] = defaultdict(int)
        self.gauges: Dict[str, float] = {}
        self.errors: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._device_pending: List[Tuple[str, float, Any, Any]] = []

    def _sid(self, name: str) -> int:
        if name not in self._ids:
            self._ids[name] = len(self._names)
            self._names.append(name)
        return self._ids[name]

    @contextmanager
    def span(self, name: str):
        ev = self.pool.get()
        t0 = time.perf_counter()
        try:
            yield
        except Exception as e:
            # O(1) error attribution: the failing span is known directly
            self.errors.append({"span": name, "time": time.time(),
                                "error": repr(e)})
            raise
        finally:
            self._record(name, t0, (time.perf_counter() - t0) * 1e6)
            self.pool.put(ev)

    def _record(self, name: str, t0: float, dur_us: float):
        # _sid mutates the span registry and SpanStats.add mutates a
        # deque + counters: both sit under the same lock as the ring
        # write, or spans closing on the Prefetcher thread race the
        # engine thread's defaultdict insertion.
        with self._lock:
            sid = self._sid(name)
            i = self.head % len(self.ring)
            self.ring[i] = (sid, int(t0 * 1e6), int(dur_us))
            self.head += 1
            if self.head >= len(self.ring):
                self.wrapped = True
            self.stats[name].add(dur_us)
        self._publish_span(name, dur_us)

    @contextmanager
    def device_span(self, name: str, device: torch.device):
        """Time the device work enqueued inside the block on `device`'s
        current stream, as span ``device/<name>`` once `collect_device`
        reads it.  Records nothing for a CPU device."""
        if device.type != "cuda":
            yield
            return
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        try:
            yield
        finally:
            b.record()
            self._device_pending.append((name, t0, a, b))

    def collect_device(self):
        """Read every pending device span (waits for its end event)."""
        pending, self._device_pending = self._device_pending, []
        for name, t0, a, b in pending:
            b.synchronize()
            self._record(f"device/{name}", t0, a.elapsed_time(b) * 1e3)

    def _publish_span(self, name: str, dur_us: float):
        if self.registry is None:
            return
        h = self._reg_hists.get(name)
        if h is None:
            h = self.registry.histogram(
                "xputimer_span_ms", "XPUTimer span duration", span=name)
            self._reg_hists[name] = h
        h.observe(dur_us / 1e3)

    def count(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] += n
        if self.registry is not None:
            self.registry.counter(
                "xputimer_counter_total", "XPUTimer counter", counter=name
            ).inc(n)

    def gauge(self, name: str, value: float):
        """Last-value gauge (e.g. commit fraction per metrics drain) —
        updated from the trainer's asynchronous drain, not per step."""
        self.gauges[name] = float(value)
        if self.registry is not None:
            self.registry.gauge(
                "xputimer_gauge", "XPUTimer gauge", gauge=name).set(value)

    # -- ring access (trace_export) -------------------------------------------
    @property
    def n_records(self) -> int:
        """Valid compressed records in the ring (single source of truth
        for the memory-accounting comparison below)."""
        return len(self.ring) if self.wrapped else min(self.head,
                                                       len(self.ring))

    # -- memory accounting (Fig. 4 comparison) --------------------------------
    def memory_bytes(self) -> int:
        return max(self.n_records, 1) * self.ring.itemsize \
            + 64 * len(self._names)

    def full_tracing_bytes(self) -> int:
        return max(self.n_records, 1) * FULL_RECORD_BYTES

    # -- diagnostic engine ------------------------------------------------------
    def diagnose(self, slow_sigma: float = 3.0) -> Dict[str, Any]:
        """Performance-degradation diagnosis: macro (throughput) + micro
        (latency distribution) metrics, straggler attribution."""
        report: Dict[str, Any] = {"spans": {}, "anomalies": [],
                                  "errors": self.errors}
        for name, st in self.stats.items():
            d = np.asarray(st.durations)
            if len(d) == 0:
                continue
            mean, std = float(d.mean()), float(d.std())
            p50, p99 = float(np.percentile(d, 50)), float(np.percentile(d, 99))
            report["spans"][name] = {
                "count": st.count, "mean_us": mean, "p50_us": p50,
                "p99_us": p99, "max_us": st.max_us,
                "total_s": st.total_us / 1e6,
            }
            slow = d[d > mean + slow_sigma * max(std, 1e-9)]
            if len(slow):
                report["anomalies"].append({
                    "span": name, "kind": "latency_outliers",
                    "n": int(len(slow)), "worst_us": float(slow.max()),
                    "mean_us": mean})
        total = sum(s["total_s"] for s in report["spans"].values())
        if total > 0:
            dominant = max(report["spans"].items(),
                           key=lambda kv: kv[1]["total_s"])
            report["dominant_span"] = {"name": dominant[0],
                                       "frac": dominant[1]["total_s"] / total}
        report["counters"] = dict(self.counters)
        report["gauges"] = dict(self.gauges)
        report["log_bytes"] = self.memory_bytes()
        report["full_tracing_bytes"] = self.full_tracing_bytes()
        return report
