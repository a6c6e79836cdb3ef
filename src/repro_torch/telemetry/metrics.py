"""Labeled metrics registry: counters, gauges, fixed-bucket histograms,
bounded series (own copy of `repro.telemetry.metrics`).

One ``MetricsRegistry`` per engine or trainer holds every metric family;
``XPUTimer`` publishes span durations into it and the ``OnlineEngine``
feeds TTFT/ITL/tick-time histograms plus queue/page counters.

Zero-host-sync contract
-----------------------
Every method on every metric accepts **plain host-side Python/numpy
scalars only**: values the caller already holds on the host (loop
counters, ``time.perf_counter()`` deltas, allocator bookkeeping ints).
Passing a ``torch.Tensor`` is a bug: reading a CUDA tensor as a float
waits for the device on the hot path.  ``_as_host_float`` rejects every
tensor, whatever its device, so the contract holds structurally.

Histograms keep two representations:

* fixed cumulative-style buckets (Prometheus exposition needs
  ``_bucket{le=...}`` counts, ``_sum`` and ``_count``), and
* a bounded sliding window of raw observations for *windowed*
  percentile snapshots (``percentile(99)``), which is what the
  ``SLOTracker`` consumes: an SLO gate must react to the last N
  requests, not the lifetime distribution.

All mutation is guarded by a per-metric lock: spans close on the
Prefetcher/exporter threads while the engine loop observes tick times.
"""
from __future__ import annotations

import bisect
import threading
from collections import deque
from typing import Dict, Iterable, List, Tuple

import torch

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Series",
    "MetricsRegistry",
    "DEFAULT_MS_BUCKETS",
]

# Latency buckets in milliseconds, from sub-millisecond spans through
# TTFTs of seconds.
DEFAULT_MS_BUCKETS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)
DEFAULT_WINDOW = 256


def _as_host_float(value) -> float:
    """Coerce to float, rejecting tensors (zero-host-sync contract)."""
    if isinstance(value, torch.Tensor):
        raise TypeError(
            "metrics accept host-side scalars only; got a torch.Tensor — "
            "read it on the host outside the hot path first")
    return float(value)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class Counter:
    """Monotonically increasing counter."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n=1.0) -> None:
        n = _as_host_float(n)
        if n < 0:
            raise ValueError(f"counters only go up (inc({n}))")
        with self._lock:
            self.value += n


class Gauge:
    """Point-in-time value (queue depth, pages in use, loss)."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v) -> None:
        v = _as_host_float(v)
        with self._lock:
            self.value = v

    def add(self, n) -> None:
        n = _as_host_float(n)
        with self._lock:
            self.value += n


class Histogram:
    """Fixed-bucket histogram plus a bounded window of raw observations.

    Bucket counts are *per-bucket* internally and cumulated only at
    render time (Prometheus ``le`` semantics).  ``percentile(q)``
    interpolates over the sliding window — O(window log window) on a
    bounded deque, host-side only.
    """

    __slots__ = ("buckets", "counts", "sum", "count", "window", "_lock")

    def __init__(self, buckets: Iterable[float] = DEFAULT_MS_BUCKETS,
                 window: int = DEFAULT_WINDOW):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0
        self.window: deque = deque(maxlen=int(window))
        self._lock = threading.Lock()

    def observe(self, v) -> None:
        v = _as_host_float(v)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            self.window.append(v)

    def percentile(self, q: float) -> float:
        """Windowed percentile over the last ``window`` observations."""
        with self._lock:
            xs = sorted(self.window)
        if not xs:
            return 0.0
        if len(xs) == 1:
            return xs[0]
        rank = (q / 100.0) * (len(xs) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(xs) - 1)
        frac = rank - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def window_count(self) -> int:
        with self._lock:
            return len(self.window)

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le, cumulative_count), ...] ending with (+inf, count)."""
        with self._lock:
            counts = list(self.counts)
        out, running = [], 0
        for le, c in zip(self.buckets, counts):
            running += c
            out.append((le, running))
        out.append((float("inf"), running + counts[-1]))
        return out


class Series:
    """Bounded time series of (t_us, value) samples for trace counter
    tracks (page-pool occupancy, queue depth, radix hit rate, spec
    acceptance).  Not exposed in Prometheus text — scrapes see the
    matching Gauge; the series feeds ``trace_export`` "C" events."""

    __slots__ = ("name", "t_us", "values", "head", "_lock")

    def __init__(self, name: str, capacity: int = 4096):
        self.name = name
        cap = max(int(capacity), 1)
        self.t_us = [0] * cap
        self.values = [0.0] * cap
        self.head = 0
        self._lock = threading.Lock()

    def sample(self, v, t_us: int) -> None:
        v = _as_host_float(v)
        with self._lock:
            i = self.head % len(self.values)
            self.t_us[i] = int(t_us)
            self.values[i] = v
            self.head += 1

    def points(self) -> List[Tuple[int, float]]:
        """Valid samples in chronological order."""
        with self._lock:
            n = len(self.values)
            if self.head <= n:
                idx = range(self.head)
            else:
                start = self.head % n
                idx = list(range(start, n)) + list(range(start))
            return [(self.t_us[i], self.values[i]) for i in idx]

    def __len__(self) -> int:
        return min(self.head, len(self.values))


class MetricsRegistry:
    """Get-or-create registry of labeled metric families.

    ``registry.counter("serve_shed_total", reason="slo")`` returns the
    child for that label set, creating family and child on first use.
    Children are cached; the hot path is a dict lookup plus a float op.
    """

    def __init__(self):
        self._lock = threading.RLock()
        # name -> (kind, help, {label_key: metric})
        self._families: Dict[str, Tuple[str, str, Dict]] = {}

    def _child(self, kind: str, name: str, help_: str, factory, labels):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (kind, help_, {})
                self._families[name] = fam
            elif fam[0] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam[0]}, "
                    f"not {kind}")
            child = fam[2].get(key)
            if child is None:
                child = factory()
                fam[2][key] = child
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._child("counter", name, help, Counter, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._child("gauge", name, help, Gauge, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_MS_BUCKETS,
                  window: int = DEFAULT_WINDOW, **labels) -> Histogram:
        return self._child("histogram", name, help,
                           lambda: Histogram(buckets, window), labels)

    def series(self, name: str, capacity: int = 4096, **labels) -> Series:
        return self._child("series", name, "",
                           lambda: Series(name, capacity), labels)

    def get(self, name: str, **labels):
        """Existing child or None — never creates."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            return fam[2].get(_label_key(labels))

    def all_series(self) -> List[Tuple[str, Tuple[Tuple[str, str], ...], Series]]:
        with self._lock:
            return [(name, key, child)
                    for name, (kind, _h, children) in self._families.items()
                    if kind == "series"
                    for key, child in children.items()]

    def snapshot(self) -> Dict[str, Dict]:
        """Plain-dict snapshot (JSON-friendly) of every non-series metric."""
        out: Dict[str, Dict] = {}
        with self._lock:
            items = [(n, k, h, dict(c))
                     for n, (k, h, c) in self._families.items()]
        for name, kind, _help, children in items:
            if kind == "series":
                continue
            fam_out = out.setdefault(name, {"type": kind, "values": {}})
            for key, child in children.items():
                label_s = _fmt_labels(key) or "{}"
                if kind == "histogram":
                    fam_out["values"][label_s] = {
                        "count": child.count,
                        "sum": child.sum,
                        "p50": child.percentile(50),
                        "p99": child.percentile(99),
                    }
                else:
                    fam_out["values"][label_s] = child.value
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4) of the registry."""
        lines: List[str] = []
        with self._lock:
            items = [(n, k, h, dict(c))
                     for n, (k, h, c) in sorted(self._families.items())]
        for name, kind, help_, children in items:
            if kind == "series":
                continue
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            for key, child in sorted(children.items()):
                if kind == "histogram":
                    for le, cum in child.cumulative():
                        le_s = "+Inf" if le == float("inf") else _fmt_value(le)
                        lkey = key + (("le", le_s),)
                        lines.append(
                            f"{name}_bucket{_fmt_labels(lkey)} {cum}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(key)} {_fmt_value(child.sum)}")
                    lines.append(
                        f"{name}_count{_fmt_labels(key)} {child.count}")
                else:
                    lines.append(
                        f"{name}{_fmt_labels(key)} {_fmt_value(child.value)}")
        return "\n".join(lines) + "\n"
