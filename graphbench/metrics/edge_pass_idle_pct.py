"""``edge_pass_idle_pct``: share of the profiled job's ``engine.edge_cards``
span (the per-edge cardinality pass, fenced) in which no operation ran on
the device: the host dispatching chunks while the card waits.

This file also holds the span arithmetic of the other readers that lay
the program's spans beside the device trace. Both are stamped in epoch
nanoseconds: the spans by the program's tracer (``t0_ns``, ``t1_ns``),
the operations by the profiler. A program whose spans carry no such
stamps gives no spans here, and these readers read nothing."""

UNIT, LAYER, MOVES = "%", "engine", "mined_edges_per_s"


def job_spans(t, name: str) -> list:
    """The spans ``name`` that overlap the profiled job's device
    operations."""
    if t.device is None or not t.device.ops:
        return []
    lo = min(op.start_ns for op in t.device.ops)
    hi = max(op.end_ns for op in t.device.ops)
    return [ev for ev in t.spans if ev["name"] == name and "t0_ns" in ev
            and ev["t0_ns"] < hi and ev["t1_ns"] > lo]


def covered_ns(ops: list, a: int, b: int) -> int:
    """Nanoseconds of [a, b) in which at least one of ``ops`` ((start,
    end) pairs sorted by start) ran."""
    busy, reach = 0, a
    for start, end in ops:
        if start >= b or reach >= b:
            break
        if end > reach:
            busy += min(end, b) - max(start, reach)
            reach = end
    return busy


def idle_pct(t, name: str):
    """Share of the profiled job's spans ``name`` in which no operation
    ran on the device, the operations clipped to each span."""
    spans = job_spans(t, name)
    total = sum(ev["t1_ns"] - ev["t0_ns"] for ev in spans)
    if total <= 0:
        return None
    ops = sorted((op.start_ns, op.end_ns) for op in t.device.ops)
    busy = sum(covered_ns(ops, ev["t0_ns"], ev["t1_ns"]) for ev in spans)
    return 100.0 * (total - busy) / total


def read(t):
    return idle_pct(t, "engine.edge_cards")
