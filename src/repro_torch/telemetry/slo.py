"""SLO tracking over windowed latency histograms, driving admission (own
copy of `repro.telemetry.slo`): TTFT/ITL deadlines drive shed decisions
for loads past the knee.  The
``SLOTracker`` consumes the windowed TTFT/ITL/tick histograms the
engine already feeds into its ``MetricsRegistry`` and answers one
question at submit time: *if we admit this request, will the windowed
p99 stay inside the configured deadlines?*

Two signals combine (both host-side scalars — zero-host-sync):

* **Backward-looking**: the windowed p99 of observed TTFT/ITL.  Once
  the last-N distribution breaches a deadline the system is already
  past the knee; admitting more work only deepens the queue.
* **Forward-looking**: an admission-time TTFT estimate.  Under fcfs
  chunked prefill the engine retires one prefill chunk per tick, so a
  request joining behind ``q`` queued prompt tokens waits roughly
  ``ceil((q + own_prompt) / prefill_chunk)`` ticks before its first
  token; multiplied by the windowed median tick time that is the
  earliest possible TTFT.  Shedding on the *estimate* is what keeps
  the p99 of **admitted** requests inside the deadline — a purely
  reactive gate only sheds after the window has already breached.

Neither signal fires until ``min_observations`` samples are in the
window, so a cold engine admits freely while the histograms warm up.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .metrics import MetricsRegistry

__all__ = ["SLOConfig", "SLOTracker"]


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Deadlines and window sizing for the ``overload="slo"`` gate.

    ttft_p99_ms      windowed p99 time-to-first-token deadline
    itl_p99_ms       optional windowed p99 inter-token-latency deadline
    window           observations kept per histogram window
    min_observations tick-time samples required before the gate arms
    headroom         safety factor on the forward TTFT estimate
                     (estimate * headroom > deadline => shed)
    """
    ttft_p99_ms: float
    itl_p99_ms: Optional[float] = None
    window: int = 128
    min_observations: int = 8
    headroom: float = 1.0

    def __post_init__(self):
        if self.ttft_p99_ms <= 0:
            raise ValueError(f"ttft_p99_ms must be > 0, got {self.ttft_p99_ms}")
        if self.itl_p99_ms is not None and self.itl_p99_ms <= 0:
            raise ValueError(f"itl_p99_ms must be > 0, got {self.itl_p99_ms}")
        if self.headroom <= 0:
            raise ValueError(f"headroom must be > 0, got {self.headroom}")


class SLOTracker:
    """Windowed-percentile view over the engine's latency histograms."""

    def __init__(self, cfg: SLOConfig, registry: MetricsRegistry):
        self.cfg = cfg
        self.registry = registry
        w = cfg.window
        self.ttft = registry.histogram(
            "serve_ttft_ms", "time to first token (admitted requests)",
            window=w)
        self.itl = registry.histogram(
            "serve_itl_ms", "inter-token latency (decode steps)", window=w)
        self.tick = registry.histogram(
            "serve_tick_ms", "engine tick wall time", window=w)
        self._m_shed = registry.counter(
            "serve_slo_shed_total", "requests shed by the SLO gate")

    # -- observations (engine hot path; host floats only) ---------------
    def observe_ttft(self, ms: float) -> None:
        self.ttft.observe(ms)

    def observe_itl(self, ms: float) -> None:
        self.itl.observe(ms)

    def observe_tick(self, ms: float) -> None:
        self.tick.observe(ms)

    # -- windowed snapshots ---------------------------------------------
    def ttft_p99(self) -> float:
        return self.ttft.percentile(99)

    def itl_p99(self) -> float:
        return self.itl.percentile(99)

    def tick_p50(self) -> float:
        return self.tick.percentile(50)

    def estimate_ttft_ms(self, queued_prompt_tokens: int,
                         prefill_chunk: int) -> float:
        """Earliest-possible TTFT for a request joining the queue now."""
        chunks = math.ceil(max(queued_prompt_tokens, 1)
                           / max(prefill_chunk, 1))
        return chunks * self.tick_p50()

    def should_shed(self, queued_prompt_tokens: int,
                    prefill_chunk: int) -> Optional[str]:
        """Reason string when admitting would breach an SLO, else None."""
        cfg = self.cfg
        if self.tick.window_count() < cfg.min_observations:
            return None  # cold start: gate not armed yet
        est = self.estimate_ttft_ms(queued_prompt_tokens, prefill_chunk)
        if est * cfg.headroom > cfg.ttft_p99_ms:
            return ("ttft_estimate "
                    f"{est:.1f}ms*{cfg.headroom:g} > {cfg.ttft_p99_ms:g}ms")
        if (self.ttft.window_count() >= cfg.min_observations
                and self.ttft_p99() > cfg.ttft_p99_ms):
            return (f"ttft_p99 {self.ttft_p99():.1f}ms "
                    f"> {cfg.ttft_p99_ms:g}ms")
        if (cfg.itl_p99_ms is not None
                and self.itl.window_count() >= cfg.min_observations
                and self.itl_p99() > cfg.itl_p99_ms):
            return (f"itl_p99 {self.itl_p99():.1f}ms "
                    f"> {cfg.itl_p99_ms:g}ms")
        return None

    def on_shed(self) -> None:
        self._m_shed.inc()

    def snapshot(self) -> dict:
        return {
            "ttft_p99_ms": self.ttft_p99(),
            "itl_p99_ms": self.itl_p99(),
            "tick_p50_ms": self.tick_p50(),
            "ttft_deadline_ms": self.cfg.ttft_p99_ms,
            "itl_deadline_ms": self.cfg.itl_p99_ms,
            "shed": int(self._m_shed.value),
        }
