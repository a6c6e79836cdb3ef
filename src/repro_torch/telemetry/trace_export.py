"""Render telemetry rings as Chrome trace-event JSON + Prometheus text
(own copy of `repro.telemetry.trace_export`).

Two export paths out of the in-process telemetry layer:

* ``chrome_trace`` / ``write_chrome_trace`` — merge the XPUTimer
  compressed ring (scheduler phases: one track per span name), the
  ``RequestLog`` lifecycle ring (one track per engine slot, with
  prefill/decode spans reconstructed from event pairs and instants for
  first-token/preempt), and the registry's ``Series`` samples (counter
  tracks: page-pool occupancy, queue depth, radix hit rate, spec
  acceptance) into one trace-event JSON file.  Open it at
  https://ui.perfetto.dev (or chrome://tracing).  Both rings share the
  ``time.perf_counter()``-microsecond timebase, so phases and slots
  line up on one timeline.

* ``MetricsServer`` — a point-in-time Prometheus text scrape
  (``GET /metrics``) on a background daemon thread, behind
  ``launch/serve.py --metrics-port``.  The handler only calls
  ``MetricsRegistry.render_prometheus()`` (host-side dict walks); it
  never touches the engine, so a scrape can never stall a tick.

Trace-event format reference: the "JSON Array/Object Format" consumed
by Perfetto — "X" complete events (ts/dur µs), "i" instants, "C"
counters, "M" metadata for process/thread names.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from .metrics import MetricsRegistry
from .request_log import EVENTS, RequestLog

__all__ = ["chrome_trace_events", "chrome_trace", "write_chrome_trace",
           "MetricsServer"]

PID_PHASES = 1    # XPUTimer spans: scheduler/engine phases
PID_SLOTS = 2     # RequestLog: one thread per engine slot
PID_COUNTERS = 3  # registry Series -> "C" counter tracks
TID_QUEUE = 10_000      # slot-less request events (enqueue/shed)
TID_ALLOCATOR = 10_001  # allocator events (radix evictions)


def _meta(pid: int, tid: Optional[int], name: str) -> Dict[str, Any]:
    ev: Dict[str, Any] = {
        "ph": "M", "pid": pid, "ts": 0,
        "name": "process_name" if tid is None else "thread_name",
        "args": {"name": name},
    }
    if tid is not None:
        ev["tid"] = tid
    return ev


def _timer_events(timer) -> List[Dict[str, Any]]:
    names = timer.span_names()
    out: List[Dict[str, Any]] = [_meta(PID_PHASES, None, "scheduler phases")]
    for sid, name in enumerate(names):
        out.append(_meta(PID_PHASES, sid, name))
    for rec in timer.records():
        sid = int(rec["sid"])
        out.append({
            "ph": "X", "pid": PID_PHASES, "tid": sid,
            "name": names[sid] if sid < len(names) else f"sid{sid}",
            "ts": int(rec["t0"]), "dur": max(int(rec["dur"]), 1),
        })
    return out


def _slot_events(rlog: RequestLog) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = [
        _meta(PID_SLOTS, None, "engine slots"),
        _meta(PID_SLOTS, TID_QUEUE, "queue"),
        _meta(PID_SLOTS, TID_ALLOCATOR, "allocator"),
    ]
    # open span per slot: (name, rid, start_us)
    open_spans: Dict[int, tuple] = {}
    named_slots = set()
    last_t = 0

    def close(slot: int, end_us: int):
        span = open_spans.pop(slot, None)
        if span is None:
            return
        name, rid, t0 = span
        out.append({
            "ph": "X", "pid": PID_SLOTS, "tid": slot,
            "name": f"{name} r{rid}", "ts": t0,
            "dur": max(end_us - t0, 1), "args": {"rid": rid},
        })

    for rec in rlog.records():
        ev = EVENTS[int(rec["ev"])]
        rid, slot = int(rec["rid"]), int(rec["slot"])
        t = int(rec["t_us"])
        tick, arg = int(rec["tick"]), int(rec["arg"])
        last_t = max(last_t, t)
        if slot >= 0 and slot not in named_slots:
            named_slots.add(slot)
            out.append(_meta(PID_SLOTS, slot, f"slot {slot}"))
        if ev == "admit":
            close(slot, t)
            open_spans[slot] = ("prefill", rid, t)
        elif ev == "prefill_done":
            close(slot, t)
            open_spans[slot] = ("decode", rid, t)
        elif ev in ("complete", "preempt"):
            close(slot, t)
            if ev == "preempt":
                out.append({
                    "ph": "i", "pid": PID_SLOTS, "tid": slot,
                    "name": f"preempt r{rid}", "ts": t, "s": "t",
                    "args": {"rid": rid, "tick": tick},
                })
        elif ev == "first_token":
            out.append({
                "ph": "i", "pid": PID_SLOTS, "tid": slot,
                "name": f"first_token r{rid}", "ts": t, "s": "t",
                "args": {"rid": rid, "tick": tick},
            })
        elif ev in ("enqueue", "shed", "requeue"):
            out.append({
                "ph": "i", "pid": PID_SLOTS, "tid": TID_QUEUE,
                "name": f"{ev} r{rid}", "ts": t, "s": "t",
                "args": {"rid": rid, "tick": tick},
            })
        elif ev == "evict":
            out.append({
                "ph": "i", "pid": PID_SLOTS, "tid": TID_ALLOCATOR,
                "name": "evict", "ts": t, "s": "t",
                "args": {"page": arg, "tick": tick},
            })
        # prefill_chunk / decode stay implicit inside their spans
    for slot in list(open_spans):
        close(slot, last_t + 1)
    return out


def _counter_events(registry: MetricsRegistry) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = [_meta(PID_COUNTERS, None, "counters")]
    for name, key, series in registry.all_series():
        track = name
        if key:
            track += "[" + ",".join(f"{k}={v}" for k, v in key) + "]"
        for t_us, v in series.points():
            out.append({
                "ph": "C", "pid": PID_COUNTERS, "tid": 0,
                "name": track, "ts": int(t_us), "args": {"value": v},
            })
    return out


def chrome_trace_events(timer=None, request_log: Optional[RequestLog] = None,
                        registry: Optional[MetricsRegistry] = None,
                        ) -> List[Dict[str, Any]]:
    """Merge whatever sources are given into one event list, with
    timestamps rebased so the trace starts near t=0."""
    events: List[Dict[str, Any]] = []
    if timer is not None:
        events.extend(_timer_events(timer))
    if request_log is not None:
        events.extend(_slot_events(request_log))
    if registry is not None:
        events.extend(_counter_events(registry))
    real = [e["ts"] for e in events if e["ph"] != "M" and e["ts"] > 0]
    if real:
        t0 = min(real)
        for e in events:
            if e["ph"] != "M":
                e["ts"] = max(e["ts"] - t0, 0)
    return events


def chrome_trace(timer=None, request_log: Optional[RequestLog] = None,
                 registry: Optional[MetricsRegistry] = None,
                 ) -> Dict[str, Any]:
    return {
        "traceEvents": chrome_trace_events(timer, request_log, registry),
        "displayTimeUnit": "ms",
    }


def write_chrome_trace(path, timer=None,
                       request_log: Optional[RequestLog] = None,
                       registry: Optional[MetricsRegistry] = None) -> int:
    """Write the trace JSON; returns the number of events written."""
    trace = chrome_trace(timer, request_log, registry)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(trace["traceEvents"])


class MetricsServer:
    """Background Prometheus-text scrape endpoint for a registry."""

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1"):
        self.registry = registry
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.split("?", 1)[0].rstrip("/") in ("", "/metrics"):
                    body = outer.registry.render_prometheus().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def log_message(self, *args):  # silence per-request stderr spam
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="metrics-server",
            daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
