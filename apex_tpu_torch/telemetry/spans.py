"""Per-request span timelines — the host-side story of one request.

The serving scheduler can say *what* happened (counters, percentiles);
this module records *when*: each request's life as a sequence of phase
marks — ``queued`` at submit, ``prefill`` entering admission,
``first_token`` when admission returns, one ``decode`` mark per chunk
the slot rode, ``retired`` at release — each an O(1) ring append of a
4-tuple (no allocation-heavy objects, no dict per event, safe on the
per-chunk hot path). ``section()`` is the host-side ``annotate``
analogue for non-request work (engine dispatch, scrape handlers).

``to_chrome_trace()`` renders the ring as Chrome-trace JSON: one lane
(tid) per request plus a lane for host sections, consecutive marks of a
request becoming complete ("X") events named by the phase they opened.
The file opens in Perfetto / chrome://tracing side by side with a
``torch.profiler`` device trace of the same run.

Dependency-free: stdlib only (the ring helper imports numpy lazily,
which this module never triggers).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

from apex_tpu_torch.telemetry.ring import Ring

# canonical request phases, in lifecycle order
PHASE_QUEUED = "queued"
PHASE_PREFILL = "prefill"
PHASE_FIRST_TOKEN = "first_token"
PHASE_DECODE = "decode"
PHASE_RETIRED = "retired"
#: out-of-band: the request was interrupted by a fault and is being
#: retried (the JAX package's resilience layer; the port's comes in a
#: later slice); note = the detected cause
PHASE_ERROR = "error"

_MARK = 0
_SECTION = 1


class SpanRecorder:
    """Bounded in-memory event log with Chrome-trace export.

    ``clock`` is injectable (the scheduler passes its own, so test
    clocks drive deterministic timelines); it must be monotonic
    seconds. The ring keeps the most recent ``capacity`` events —
    ``summary()`` reports how many were dropped so a truncated export
    is never mistaken for a complete one.
    """

    def __init__(self, capacity: int = 65536,
                 clock=time.perf_counter):
        self._events = Ring(capacity)
        self.clock = clock

    # -- recording (hot path) ----------------------------------------------

    def mark(self, request_id: str, phase: str,
             note: Optional[str] = None) -> None:
        """O(1): stamp ``request_id`` entering ``phase`` now."""
        self._events.append(
            (_MARK, self.clock(), request_id, phase, note))

    @contextlib.contextmanager
    def section(self, name: str):
        """Host-side named range (engine dispatch, scrape, IO) — the
        wall-clock sibling of :func:`apex_tpu_torch.profiler.annotate`."""
        t0 = self.clock()
        try:
            yield
        finally:
            self._events.append((_SECTION, t0, name, self.clock(), None))

    def section_at(self, name: str, t_start: float, t_end: float) -> None:
        """Record an already-measured range (a caller that timed the
        interval itself — e.g. the scheduler's dispatch timing, which it
        needs for throughput accounting anyway)."""
        self._events.append((_SECTION, t_start, name, t_end, None))

    # -- export -------------------------------------------------------------

    def events(self) -> List[tuple]:
        """Retained events, oldest first (mostly for tests)."""
        return self._events.values()

    def summary(self) -> Dict[str, Any]:
        evs = self._events.values()
        reqs = {e[2] for e in evs if e[0] == _MARK}
        return {
            "events": len(evs),
            "events_total": self._events.total,
            "events_dropped": self._events.dropped,
            "requests": len(reqs),
        }

    def clear(self) -> None:
        self._events.clear()

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Render as a Chrome-trace dict (``json.dump`` it to a file and
        open in Perfetto). Request lanes are pid 1; host sections pid 2.
        Timestamps are microseconds relative to the earliest retained
        event (Chrome trace wants µs; the absolute epoch is whatever
        ``clock`` counts from and carries no meaning across processes).
        """
        evs = self._events.values()
        if not evs:
            return {"traceEvents": [], "displayTimeUnit": "ms"}
        t0 = min(e[1] for e in evs)
        us = lambda t: (t - t0) * 1e6

        out: List[Dict[str, Any]] = [
            {"ph": "M", "pid": 1, "name": "process_name",
             "args": {"name": "serving requests"}},
            {"ph": "M", "pid": 2, "name": "process_name",
             "args": {"name": "host sections"}},
            {"ph": "M", "pid": 2, "tid": 0, "name": "thread_name",
             "args": {"name": "sections"}},
        ]
        # one lane per request, in order of first appearance
        lanes: Dict[str, int] = {}
        last_mark: Dict[str, tuple] = {}
        for e in evs:
            if e[0] == _SECTION:
                _, t_start, name, t_end, _ = e
                out.append({"ph": "X", "pid": 2, "tid": 0, "name": name,
                            "ts": us(t_start),
                            "dur": max(us(t_end) - us(t_start), 0.0)})
                continue
            _, t, rid, phase, note = e
            tid = lanes.get(rid)
            if tid is None:
                tid = lanes[rid] = len(lanes)
                out.append({"ph": "M", "pid": 1, "tid": tid,
                            "name": "thread_name",
                            "args": {"name": f"req {rid}"}})
            prev = last_mark.get(rid)
            if prev is not None:
                prev_t, prev_phase, prev_note = prev
                span = {"ph": "X", "pid": 1, "tid": tid,
                        "name": prev_phase, "ts": us(prev_t),
                        "dur": max(us(t) - us(prev_t), 0.0)}
                if prev_note:
                    span["args"] = {"note": prev_note}
                out.append(span)
            last_mark[rid] = (t, phase, note)
        # terminal (or dangling-latest) marks become instant events
        for rid, (t, phase, note) in last_mark.items():
            inst = {"ph": "i", "pid": 1, "tid": lanes[rid], "name": phase,
                    "ts": us(t), "s": "t"}
            if note:
                inst["args"] = {"note": note}
            out.append(inst)
        return {"traceEvents": out, "displayTimeUnit": "ms"}
