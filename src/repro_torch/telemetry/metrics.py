"""Labeled metrics registry: counters, gauges, fixed-bucket histograms
(own copy of the part of `repro.telemetry.metrics` the trainer and
`XPUTimer` use).

Zero-host-sync contract: every method on every metric accepts plain
host-side Python/numpy scalars only.  Passing a `torch.Tensor` is a bug
(reading a CUDA tensor as a float waits for the device), and
`_as_host_float` rejects any tensor, so the contract holds structurally.
Histograms keep fixed buckets plus a bounded window of raw observations
for windowed percentiles.  All mutation is guarded by a per-metric lock.
"""
from __future__ import annotations

import bisect
import threading
from collections import deque
from typing import Dict, Iterable, Tuple

import torch

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_MS_BUCKETS",
]

# Latency buckets in milliseconds, from sub-millisecond spans through
# steps of seconds.
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

    def snapshot(self) -> Dict[str, Dict]:
        """Plain-dict snapshot (JSON-friendly) of every metric."""
        out: Dict[str, Dict] = {}
        with self._lock:
            items = [(n, k, h, dict(c))
                     for n, (k, h, c) in self._families.items()]
        for name, kind, _help, children in items:
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
