"""Span-based tracer: ring-buffer event log with Chrome-trace JSON export.

The runtime's request-lifecycle and step-phase story ("assemble, then one
chunk for request 3, then the shared ragged decode, then the page-stats
fold — and THEN the supervisor killed the process") is a timeline, not a
counter. This module records it as nested spans and instant events on an
**injectable monotonic clock** (deterministic tests, deadline-consistent
serving) in a bounded ring buffer (old events evicted, a long-running
server never grows without bound), and exports the standard Chrome
trace-event JSON that ``chrome://tracing`` and https://ui.perfetto.dev load
directly.

Zero-cost-when-disabled contract: a disabled tracer's ``span``/``instant``
are guard-checked no-ops on the host — instrumented code never adds device
work either way, so observability on/off cannot change what the device
computes.

Chrome trace-event mapping (the subset every viewer supports):

* spans  -> ``"ph": "X"`` complete events (``ts`` + ``dur``, microseconds);
  nesting is implied by containment on the same ``(pid, tid)`` track;
* instants -> ``"ph": "i"`` with ``"s": "t"`` (thread scope);
* counter samples -> ``"ph": "C"`` (Perfetto renders a track per series).
"""
from __future__ import annotations

import collections
import json
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List

# One logical process for the whole trace; tracks ("tid") name subsystems.
PID = 1
DEFAULT_TRACK = "engine"


class Tracer:
    """Bounded in-memory trace log.

    ``capacity`` bounds the ring buffer (events, not bytes); ``clock`` is
    any monotonic ``() -> seconds`` callable — inject a fake for
    deterministic output. ``enabled=False`` builds the shared no-op tracer:
    every record method returns immediately (`span` yields without
    touching the clock), so instrumentation can call it unconditionally.
    """

    def __init__(self, capacity: int = 65536,
                 clock: Callable[[], float] = time.perf_counter,
                 enabled: bool = True):
        self.enabled = enabled
        self.capacity = capacity
        self.clock = clock
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._tracks: Dict[str, int] = {}
        self._depth: Dict[str, int] = {}
        self.dropped = 0

    # --------------------------- recording --------------------------- #
    def _tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            tid = self._tracks[track] = len(self._tracks) + 1
        return tid

    def _push(self, ev: tuple) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    @contextmanager
    def span(self, name: str, track: str = DEFAULT_TRACK,
             **args) -> Iterator[None]:
        """Timed nested span (Chrome ``X`` event). Exception-safe: the span
        closes (and is recorded) even if the body raises."""
        if not self.enabled:
            yield
            return
        depth = self._depth.get(track, 0)
        self._depth[track] = depth + 1
        t0 = self.clock()
        try:
            yield
        finally:
            t1 = self.clock()
            self._depth[track] = depth
            self._push(("X", name, track, t0, t1 - t0, depth,
                        args or None))

    def instant(self, name: str, track: str = DEFAULT_TRACK, **args) -> None:
        """Point-in-time event (Chrome ``i`` event)."""
        if not self.enabled:
            return
        self._push(("i", name, track, self.clock(), 0.0,
                    self._depth.get(track, 0), args or None))

    def counter(self, name: str, value: float,
                track: str = DEFAULT_TRACK) -> None:
        """Counter sample (Chrome ``C`` event — a value-over-time track)."""
        if not self.enabled:
            return
        self._push(("C", name, track, self.clock(), 0.0, 0,
                    {"value": value}))

    # ---------------------------- reading ----------------------------- #
    def __len__(self) -> int:
        return len(self._events)

    def events(self) -> List[dict]:
        """Decoded events, oldest first (tests/analysis; the export path
        is :meth:`to_chrome_trace`)."""
        return [{"ph": ph, "name": name, "track": track, "ts": ts,
                 "dur": dur, "depth": depth, "args": args}
                for ph, name, track, ts, dur, depth, args in self._events]

    def find(self, name: str) -> List[dict]:
        return [e for e in self.events() if e["name"] == name]

    # ---------------------------- export ------------------------------ #
    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (load in chrome://tracing or
        https://ui.perfetto.dev). Deterministic given a deterministic
        clock: events keep ring order, track ids keep first-use order."""
        body: List[dict] = []
        for ph, name, track, ts, dur, depth, args in self._events:
            ev = {"ph": ph, "name": name, "pid": PID,
                  "tid": self._tid(track), "ts": round(ts * 1e6, 3)}
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            if ph == "i":
                ev["s"] = "t"
            if args is not None:
                ev["args"] = args
            body.append(ev)
        # metadata AFTER the body walk: that's what assigns track ids
        meta = [{"ph": "M", "name": "thread_name", "pid": PID, "tid": tid,
                 "args": {"name": track}}
                for track, tid in sorted(self._tracks.items(),
                                         key=lambda kv: kv[1])]
        return {"traceEvents": meta + body, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def to_json(self, **dump_kw) -> str:
        return json.dumps(self.to_chrome_trace(), sort_keys=True, **dump_kw)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


# The shared disabled tracer: safe default for every instrumented module.
NULL_TRACER = Tracer(capacity=0, enabled=False)


def validate_chrome_trace(doc: dict) -> None:
    """Schema check used by tests and the benchmark gate: raises on
    anything chrome://tracing / Perfetto would reject."""
    assert isinstance(doc, dict) and isinstance(doc.get("traceEvents"), list)
    json.dumps(doc)   # must be pure JSON
    for ev in doc["traceEvents"]:
        assert isinstance(ev.get("name"), str) and ev["name"]
        assert ev.get("ph") in ("X", "i", "C", "M"), ev
        assert isinstance(ev.get("pid"), int)
        assert isinstance(ev.get("tid"), int)
        if ev["ph"] == "M":
            continue
        assert isinstance(ev.get("ts"), (int, float)) and ev["ts"] >= 0
        if ev["ph"] == "X":
            assert isinstance(ev.get("dur"), (int, float)) and ev["dur"] >= 0
        if ev["ph"] == "i":
            assert ev.get("s") in ("t", "p", "g")
