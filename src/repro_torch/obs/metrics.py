"""Labelled metrics registry: counters, gauges, and windowed histograms.

One :class:`MetricsRegistry` owns every metric; instruments are created (or
fetched) by ``registry.counter(name, **labels)`` and friends, keyed on
``(name, sorted-labels)`` so the same call site always returns the same
instrument. ``snapshot()`` flattens everything to one JSON-serializable dict
(``name{k=v,...}`` keys, Prometheus-style), which ``--metrics`` CLI flags
embed. Histograms keep a bounded deque window and expose the raw values so
consumers can apply their own summary math.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, Optional, Tuple

import numpy as np

LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: dict) -> LabelKey:
    return (name, tuple(sorted((str(k), str(v)) for k, v in labels.items())))


def _flat_name(key: LabelKey) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic (but resettable) integer counter.

    Mutations hold a per-instrument lock: ``self._value += amount`` is a
    read-modify-write spanning several bytecodes, so unlocked concurrent
    increments lose updates (the background flush worker and the delta
    thread both hit serving counters).
    """

    # pgcheck PG001: the count moves only under the per-instrument lock;
    # reads are free (a torn read of an int is impossible in CPython, and
    # the `value` property is an intentionally unlocked snapshot)
    _GUARDED_BY = {"_value": "write:_lock"}

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, amount: int = 1) -> int:
        """Add ``amount`` (default 1); returns the new value."""
        with self._lock:
            self._value += amount
            return self._value

    def set(self, value: int) -> None:
        """Overwrite the count (checkpoint restore / view-backed attrs)."""
        with self._lock:
            self._value = int(value)

    @property
    def value(self) -> int:
        """Current count."""
        return self._value


class Gauge:
    """Last-write-wins scalar (``add`` is locked: it is a read-modify-write)."""

    _GUARDED_BY = {"_value": "write:_lock"}  # pgcheck PG001; see Counter

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> float:
        """Record the latest value; returns it."""
        with self._lock:
            self._value = value
        return value

    def add(self, amount: float) -> float:
        """Adjust the gauge by ``amount``; returns the new value."""
        with self._lock:
            self._value += amount
            return self._value

    @property
    def value(self) -> float:
        """Most recently recorded value."""
        return self._value


class Histogram:
    """Sliding-window histogram over the last ``window`` observations.

    Keeps raw values (bounded deque) rather than buckets so consumers can
    apply their own summary math — the serving-stats view recomputes
    ``mean``/``np.percentile`` from :meth:`values` and stays bit-compatible
    with the pre-registry implementation.
    """

    # pgcheck PG001: deque mutation and iteration must not race (appending
    # past maxlen while iterating raises); `count` reads are free snapshots
    _GUARDED_BY = {"_window": "_lock", "count": "write:_lock"}

    __slots__ = ("_window", "count", "_lock")

    def __init__(self, window: Optional[int] = 4096):
        self._window = collections.deque(maxlen=window)
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        """Record one observation (locked: ``count += 1`` is a
        read-modify-write, and deque mutation must not race readers)."""
        with self._lock:
            self._window.append(float(value))
            self.count += 1

    def values(self) -> np.ndarray:
        """The retained window as a float64 array (oldest first).

        Locked against :meth:`observe`: iterating a deque while another
        thread appends past ``maxlen`` raises ``RuntimeError``.
        """
        with self._lock:
            return np.asarray(self._window, dtype=np.float64)

    def summary(self) -> dict:
        """``{"count", "mean", "p50", "p95", "max"}`` over the window."""
        vals = self.values()
        if vals.size == 0:
            return {"count": self.count, "mean": 0.0, "p50": 0.0,
                    "p95": 0.0, "max": 0.0}
        return {
            "count": self.count,
            "mean": float(vals.mean()),
            "p50": float(np.percentile(vals, 50)),
            "p95": float(np.percentile(vals, 95)),
            "max": float(vals.max()),
        }


class MetricsRegistry:
    """Thread-safe, label-aware home for counters/gauges/histograms."""

    # pgcheck PG001: fetch-or-create and enumeration both hold the lock —
    # an unlocked fast path could observe a registration mid-flight
    _GUARDED_BY = {"_metrics": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[LabelKey, object] = {}

    def _get(self, name: str, labels: dict, factory):
        # fully locked — an unlocked fast path over the dict could observe
        # another thread's registration mid-flight; fetch-or-create is cheap
        # enough that call sites which care hold the instrument instead
        key = _key(name, labels)
        with self._lock:
            inst = self._metrics.get(key)
            if inst is None:
                inst = self._metrics[key] = factory()
        return inst

    def counter(self, name: str, **labels) -> Counter:
        """Fetch-or-create the counter for ``(name, labels)``."""
        return self._get(name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        """Fetch-or-create the gauge for ``(name, labels)``."""
        return self._get(name, labels, Gauge)

    def histogram(self, name: str, window: Optional[int] = 4096,
                  **labels) -> Histogram:
        """Fetch-or-create the histogram for ``(name, labels)``.

        ``window`` only applies on first creation.
        """
        return self._get(name, labels, lambda: Histogram(window))

    def value(self, name: str, **labels):
        """Current value of a counter/gauge (None if never created)."""
        with self._lock:
            inst = self._metrics.get(_key(name, labels))
        return None if inst is None else inst.value

    def labelled(self, name: str) -> Dict[Tuple[Tuple[str, str], ...], object]:
        """Every instrument registered under ``name``, keyed by its sorted
        label tuple (``dict(key)`` recovers the label dict).

        The enumeration view the stat facades use to rebuild per-label
        dicts (e.g. served-by-kind) straight from the registry.
        """
        with self._lock:
            items = list(self._metrics.items())
        return {labels: inst for (n, labels), inst in items if n == name}

    def snapshot(self) -> dict:
        """Flatten every instrument to one ``{flat_name: number}`` dict.

        Histograms expand to ``_count``/``_mean``/``_p50``/``_p95``/``_max``
        suffixed entries. Keys are Prometheus-style ``name{k=v,...}``.
        """
        with self._lock:
            items = list(self._metrics.items())
        out: dict = {}
        for key, inst in sorted(items, key=lambda kv: _flat_name(kv[0])):
            flat = _flat_name(key)
            if isinstance(inst, Histogram):
                for suffix, val in inst.summary().items():
                    out[f"{flat}_{suffix}"] = val
            else:
                out[flat] = inst.value
        return out

    def reset(self) -> None:
        """Drop every instrument (tests / fresh bench suites)."""
        with self._lock:
            self._metrics.clear()


#: process-global registry — CLI ``--metrics`` and benches snapshot this
REGISTRY = MetricsRegistry()

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY"]
