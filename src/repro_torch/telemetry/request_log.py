"""Per-request lifecycle event log for the online engine (own copy of
`repro.telemetry.request_log`).

Every request admitted to ``OnlineEngine`` leaves a trail:

    enqueue -> admit -> prefill_chunk* -> prefill_done -> first_token
            -> decode* -> (preempt -> requeue -> admit -> prefill_chunk*)*
            -> complete | shed

plus allocator-side ``evict`` events when the radix cache drops pages.
Events live in an XPUTimer-style compressed numpy ring (35 bytes per
record vs. a ~200-byte dict+timestamp tuple for a naive log), so an
always-on log of the last 64Ki events costs ~2 MiB and O(1) per event.

Records carry the request id, the engine tick index, a wall timestamp
(``time.perf_counter()`` microseconds — the same timebase XPUTimer
uses, so ``trace_export`` can merge both onto one Perfetto timeline),
the slot involved (-1 when not slot-bound, e.g. enqueue/shed) and one
free integer argument (tokens in a prefill chunk, tokens committed by
a decode/spec step, page id for evictions).

Host-side only: callers pass ints they already hold (zero-host-sync
contract, see ``telemetry.metrics``).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["RequestLog", "EVENTS", "EV"]

# Order is part of the on-ring encoding; append only.
EVENTS = (
    "enqueue",        # submit() accepted into the queue
    "shed",           # submit() rejected by the admission gate
    "admit",          # scheduler bound the request to a slot
    "prefill_chunk",  # one chunked-prefill step fed `arg` tokens
    "prefill_done",   # prompt fully fed; slot enters decode
    "first_token",    # first generated token surfaced (TTFT point)
    "decode",         # decode/spec step committed `arg` tokens
    "preempt",        # slot reclaimed; fed prefix trimmed to page edge
    "requeue",        # preempted request re-entered the queue
    "evict",          # radix cache evicted page `arg` (rid = -1)
    "complete",       # request finished (eos or max_new)
)
EV: Dict[str, int] = {name: i for i, name in enumerate(EVENTS)}

_DTYPE = np.dtype([
    ("rid", "i8"),    # request id (-1 for allocator-level events)
    ("ev", "u1"),     # index into EVENTS
    ("slot", "i2"),   # slot id or -1
    ("tick", "i8"),   # engine tick index at record time
    ("t_us", "u8"),   # perf_counter microseconds (XPUTimer timebase)
    ("arg", "i8"),    # event-specific payload (tokens / page id)
])


class RequestLog:
    """Compressed ring of lifecycle events, queryable per request id."""

    def __init__(self, ring_size: int = 65536):
        self.ring = np.zeros(max(int(ring_size), 1), dtype=_DTYPE)
        self.head = 0
        self.wrapped = False
        self._lock = threading.Lock()

    def record(self, event: str, rid: int, *, slot: int = -1,
               tick: int = -1, arg: int = 0,
               t_us: Optional[int] = None) -> None:
        ev = EV[event]  # KeyError on typo'd event names, by design
        if t_us is None:
            t_us = int(time.perf_counter() * 1e6)
        with self._lock:
            i = self.head % len(self.ring)
            rec = self.ring[i]
            rec["rid"] = rid
            rec["ev"] = ev
            rec["slot"] = slot
            rec["tick"] = tick
            rec["t_us"] = t_us
            rec["arg"] = arg
            self.head += 1
            if self.head > len(self.ring):
                self.wrapped = True

    @property
    def n_records(self) -> int:
        return min(self.head, len(self.ring))

    def records(self) -> np.ndarray:
        """Copy of the valid region in chronological order."""
        with self._lock:
            if not self.wrapped:
                return self.ring[: self.head].copy()
            start = self.head % len(self.ring)
            return np.concatenate([self.ring[start:], self.ring[:start]])

    def events_for(self, rid: int) -> List[dict]:
        """Chronological [{event, slot, tick, t_us, arg}, ...] for one rid."""
        recs = self.records()
        out = []
        for rec in recs[recs["rid"] == rid]:
            out.append({
                "event": EVENTS[int(rec["ev"])],
                "slot": int(rec["slot"]),
                "tick": int(rec["tick"]),
                "t_us": int(rec["t_us"]),
                "arg": int(rec["arg"]),
            })
        return out

    def counts(self) -> Dict[str, int]:
        """Event-name -> occurrence count over the valid region."""
        recs = self.records()
        binc = np.bincount(recs["ev"], minlength=len(EVENTS))
        return {name: int(binc[i]) for i, name in enumerate(EVENTS)
                if binc[i]}

    def memory_bytes(self) -> int:
        return len(self.ring) * self.ring.itemsize
