"""Low-overhead structured span tracer with Chrome-trace/Perfetto export.

One process-wide :class:`Tracer` records named spans into a thread-safe
bounded ring buffer. Spans are context managers (``with span("name",
k=v)``) and nest through a thread-local stack, so the export
reconstructs the call tree without global locking on the hot path.

Clock: every span is stamped in integer epoch nanoseconds (``t0_ns``,
``t1_ns``), the clock ``torch.profiler`` stamps its host and device
events with. The tracer takes one anchor pair (``time.time_ns()``,
``time.perf_counter_ns()``) when it is made and at each :meth:`Tracer.clear`
and adds ``perf_counter_ns`` deltas to it, so durations stay monotonic
and a span can be laid beside the device operations of a profiler trace.
While a profiler records, each span also enters a
``torch.profiler.record_function`` of its own name, so the profiler's
trace shows what the program was doing between its operations.

Attribution under CUDA's asynchronous launches: a span can *fence* a
device value (``sp.fence(out)``). The fence stamps the time of its call
(``enqueue_us``: host time from the span's start until its device work
was all enqueued), and span exit then synchronizes the value's CUDA
device **before** reading the clock, so ``dur`` charges the device work
to the span that launched it. Fencing only happens while tracing is
enabled; the disabled path is a single flag check returning a shared
no-op span, so instrumented code keeps launches asynchronous.

Export is the Chrome trace-event JSON format (``ph: "X"`` complete events,
microsecond timestamps), which loads directly in Perfetto;
``aggregate()`` gives per-span-name count/total wall time.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional

#: seconds of the interval Kineto floors a Chrome trace's base time to
#: (``baseTimeNanoseconds``); the export uses the same rule so that it
#: and ``prof.export_chrome_trace`` share one time base
_TRACE_BASE_S = 7889238


class _NullSpan:
    """The shared no-op span returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        """No-op attribute update (tracing disabled)."""
        return self

    def fence(self, value):
        """Pass the value through without blocking (tracing disabled)."""
        return value


_NULL_SPAN = _NullSpan()


def _profiler_recording() -> bool:
    """Is a ``torch.profiler`` recording in this process (about 0.2 µs)?"""
    from torch._C._autograd import _profiler_enabled
    return _profiler_enabled()


class _Span:
    """One live span: records name/attrs/parent and times its ``with`` body."""

    __slots__ = ("_tracer", "name", "attrs", "_fenced", "_enqueued", "_t0",
                 "_parent", "_depth", "_annotation")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._fenced = None
        self._enqueued = None

    def set(self, **attrs):
        """Attach/overwrite span attributes from inside the body."""
        self.attrs.update(attrs)
        return self

    def fence(self, value):
        """Register a tensor whose CUDA device is synchronized at span exit,
        so its device work is attributed to this span, and stamp the time
        its work was all enqueued; returns the value."""
        self._enqueued = time.perf_counter_ns()
        self._fenced = value
        return value

    def __enter__(self):
        stack = self._tracer._stack()
        self._parent = stack[-1].name if stack else None
        self._depth = len(stack)
        stack.append(self)
        # the clock is read outside the annotation at both ends, so the
        # profiler's event of the span lies inside [t0_ns, t1_ns]
        self._t0 = time.perf_counter_ns()
        self._annotation = None
        if _profiler_recording():
            import torch
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if self._fenced is not None:
                from .._device import synchronize
                synchronize(self._fenced)
        finally:
            self._fenced = None
            if self._annotation is not None:
                self._annotation.__exit__(exc_type, exc, tb)
                self._annotation = None
            t1 = time.perf_counter_ns()
            stack = self._tracer._stack()
            if stack and stack[-1] is self:
                stack.pop()
            self._tracer._record(self.name, self._t0, t1, self._enqueued,
                                 self._parent, self._depth, self.attrs,
                                 error=exc_type is not None)
        return False


class Tracer:
    """Thread-safe bounded ring buffer of completed spans.

    Most callers use the module-level singleton through :func:`span` /
    :func:`enable` / :func:`export`; independent tracers exist mainly for
    tests.
    """

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self.enabled = False
        self._events: "collections.deque[dict]" = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._anchor = (time.time_ns(), time.perf_counter_ns())
        self.recorded = 0          # total spans ever recorded (ring may drop)

    # -- hot path -----------------------------------------------------------

    def span(self, name: str, **attrs):
        """Open a span context manager (no-op singleton while disabled)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, name: str, t0: int, t1: int, enqueued: Optional[int],
                parent: Optional[str], depth: int, attrs: dict,
                error: bool = False) -> None:
        epoch, perf = self._anchor
        t0_ns = epoch + (t0 - perf)
        event = {
            "name": name,
            "t0_ns": t0_ns,
            "t1_ns": t0_ns + (t1 - t0),
            "ts": t0_ns * 1e-3,               # epoch µs
            "dur": (t1 - t0) * 1e-3,
            "tid": threading.get_ident(),
            "parent": parent,
            "depth": depth,
            "args": attrs,
        }
        if enqueued is not None:
            event["enqueue_us"] = (enqueued - t0) * 1e-3
        if error:
            event["error"] = True
        with self._lock:
            self._events.append(event)
            self.recorded += 1

    # -- control ------------------------------------------------------------

    def enable(self, capacity: Optional[int] = None) -> None:
        """Turn tracing on (optionally resizing the ring buffer)."""
        if capacity is not None and int(capacity) != self.capacity:
            self.capacity = int(capacity)
            with self._lock:
                self._events = collections.deque(self._events,
                                                 maxlen=self.capacity)
        self.enabled = True

    def disable(self) -> None:
        """Turn tracing off (recorded spans are kept until ``clear``)."""
        self.enabled = False

    def clear(self) -> None:
        """Drop every recorded span and take a new clock anchor."""
        with self._lock:
            self._events.clear()
            self.recorded = 0
            self._anchor = (time.time_ns(), time.perf_counter_ns())

    # -- reads --------------------------------------------------------------

    def events(self) -> List[dict]:
        """A snapshot list of the recorded span events (oldest first)."""
        with self._lock:
            return list(self._events)

    def aggregate(self) -> Dict[str, dict]:
        """Per-span-name ``{"count", "total_s", "mean_s"}`` breakdown."""
        out: Dict[str, dict] = {}
        for ev in self.events():
            agg = out.setdefault(ev["name"], {"count": 0, "total_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += ev["dur"] * 1e-6
        for agg in out.values():
            agg["mean_s"] = agg["total_s"] / agg["count"]
        return out

    def export(self, path: Optional[str] = None) -> dict:
        """Chrome trace-event JSON (loads in Perfetto); optionally written
        to ``path``.

        Every span becomes one complete event (``ph: "X"``) with
        microsecond ``ts``/``dur``; ``ts`` counts from
        ``baseTimeNanoseconds``, chosen by Kineto's rule, so this export
        and a profiler's Chrome trace of the same stretch line up. Span
        attributes plus the recorded parent/depth (and a fenced span's
        ``enqueue_us``) land under ``args`` so tools (and tests) can
        rebuild the span tree without timestamp containment heuristics.
        """
        events = self.events()
        first_s = (events[0]["t0_ns"] if events else time.time_ns()) // 10**9
        base = first_s // _TRACE_BASE_S * _TRACE_BASE_S * 10**9
        pid = os.getpid()
        tids: Dict[int, int] = {}
        trace_events = []
        for ev in events:
            tid = tids.setdefault(ev["tid"], len(tids))
            args = dict(ev["args"])
            args["parent"] = ev["parent"]
            args["depth"] = ev["depth"]
            if "enqueue_us" in ev:
                args["enqueue_us"] = round(ev["enqueue_us"], 3)
            trace_events.append({
                "name": ev["name"], "cat": "repro_torch", "ph": "X",
                "ts": round((ev["t0_ns"] - base) * 1e-3, 3),
                "dur": round(ev["dur"], 3),
                "pid": pid, "tid": tid, "args": args,
            })
        doc = {"traceEvents": trace_events, "displayTimeUnit": "ms",
               "baseTimeNanoseconds": base,
               "otherData": {"recorded": self.recorded,
                             "capacity": self.capacity}}
        if path:
            with open(path, "w") as fh:
                json.dump(doc, fh)
        return doc


#: the process-wide tracer every instrumented seam records into
TRACER = Tracer()


def span(name: str, **attrs):
    """Open a span on the global tracer: ``with trace.span("x", k=v) as sp``.

    Returns a shared no-op object while tracing is disabled — safe (and
    near-free) to leave in hot paths. Keep attribute expressions cheap at
    call sites: they are evaluated even when disabled.
    """
    if not TRACER.enabled:
        return _NULL_SPAN
    return _Span(TRACER, name, attrs)


def enable(capacity: Optional[int] = None) -> None:
    """Enable the global tracer (see :meth:`Tracer.enable`)."""
    TRACER.enable(capacity)


def disable() -> None:
    """Disable the global tracer (recorded spans kept)."""
    TRACER.disable()


def enabled() -> bool:
    """Is the global tracer currently recording?"""
    return TRACER.enabled


def clear() -> None:
    """Drop the global tracer's recorded spans."""
    TRACER.clear()


def events() -> List[dict]:
    """Snapshot of the global tracer's span events."""
    return TRACER.events()


def aggregate() -> Dict[str, dict]:
    """Per-span-name breakdown of the global tracer's events."""
    return TRACER.aggregate()


def export(path: Optional[str] = None) -> dict:
    """Chrome-trace export of the global tracer (see :meth:`Tracer.export`)."""
    return TRACER.export(path)


__all__ = ["TRACER", "Tracer", "aggregate", "clear", "disable", "enable",
           "enabled", "events", "export", "span"]
