"""Telemetry (own copy of `repro.telemetry`): XPUTimer tracing, metrics
registry, request lifecycle log, Perfetto/Prometheus export, SLO
tracking."""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                      Series)
from .request_log import EVENTS, RequestLog  # noqa: F401
from .slo import SLOConfig, SLOTracker  # noqa: F401
from .trace_export import (MetricsServer, chrome_trace,  # noqa: F401
                           chrome_trace_events, write_chrome_trace)
from .xputimer import XPUTimer  # noqa: F401
