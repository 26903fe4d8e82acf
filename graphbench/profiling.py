"""Reduces a ``torch.profiler`` trace of a few jobs to what the per-layer
metrics and the result's ``breakdown`` read.

The raw Kineto events are read directly (building PyTorch's event tree
for some 10^5 events would take longer than the jobs). Device operations
are attributed to the job phase whose ``graphbench.*`` annotation was open
on the host when their launch call ran (matched by correlation id), and
every idle stretch of the device to what the host was doing in its middle.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

from torch.autograd import DeviceType

#: prefix of the host annotations the harness puts around jobs and phases
PREFIX = "graphbench."


@dataclasses.dataclass
class DeviceOp:
    """One operation that ran on the device: kernel, copy or fill."""

    name: str
    start_ns: int
    end_ns: int
    phase: Optional[str]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def is_kernel(self) -> bool:
        low = self.name.lower()
        return not (low.startswith("memcpy") or low.startswith("memset"))


@dataclasses.dataclass
class DeviceTrace:
    """The device's operations in a traced stretch of ``jobs`` jobs and
    the idle gaps between them, labelled by the host's activity."""

    ops: List[DeviceOp]
    gaps: Dict[str, float]
    jobs: int
    window_s: float

    @property
    def busy_s(self) -> float:
        """Seconds in which at least one operation ran on the device."""
        busy, reach = 0, None
        for op in sorted(self.ops, key=lambda o: o.start_ns):
            if reach is None or op.start_ns >= reach:
                busy += op.end_ns - op.start_ns
                reach = op.end_ns
            elif op.end_ns > reach:
                busy += op.end_ns - reach
                reach = op.end_ns
        return busy * 1e-9

    def seconds_where(self, pred) -> float:
        return sum(op.seconds for op in self.ops if pred(op))

    def top_ops(self, count: int = 10) -> List[list]:
        """The operations that took most device time: [name, seconds],
        names cut to their first ``NAME_CHARS`` characters."""
        total: Dict[str, float] = collections.Counter()
        for op in self.ops:
            total[op.name] += op.seconds
        return [[_short(name), s] for name, s in total.most_common(count)]

    def top_gaps(self, count: int = 10) -> List[list]:
        return [[name, s] for name, s in
                collections.Counter(self.gaps).most_common(count)]


#: characters of an operation's name kept in the breakdown
NAME_CHARS = 120


def _short(name: str) -> str:
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 1] + "…"


def _times(ev) -> Tuple[int, int]:
    start = ev.start_ns()
    return start, start + ev.duration_ns()


def reduce(prof, jobs: int, window_s: float) -> DeviceTrace:
    """The :class:`DeviceTrace` of a stopped ``torch.profiler.profile``."""
    events = list(prof.profiler.kineto_results.events())
    host, device = [], []
    for ev in events:
        if ev.device_type() == DeviceType.CPU:
            host.append(ev)
        elif (not ev.is_user_annotation()
              and not ev.name().startswith(PREFIX)):
            device.append(ev)
    marks = [ev for ev in host if ev.name().startswith(PREFIX)]
    main = marks[0].start_thread_id() if marks else None
    # phases: the innermost graphbench annotation open at a host time
    phases = _Nest([(*_times(ev), ev.name()[len(PREFIX):]) for ev in marks])
    launch = {ev.correlation_id(): _times(ev)[0] for ev in host
              if ev.correlation_id() and ev.name().startswith("cu")}
    ops = []
    for ev in device:
        start, end = _times(ev)
        at = launch.get(ev.correlation_id())
        ops.append(DeviceOp(ev.name(), start, end,
                            None if at is None else phases.at(at)))
    work = _Nest([(*_times(ev), ev.name()) for ev in host
                  if ev.start_thread_id() == main])
    gaps: Dict[str, float] = collections.Counter()
    if marks:
        lo = min(_times(ev)[0] for ev in marks)
        hi = max(_times(ev)[1] for ev in marks)
        for g0, g1 in _idle(ops, lo, hi):
            mid = (g0 + g1) // 2
            phase = phases.at(mid) or "between jobs"
            doing = work.at(mid)
            what = doing if doing and not doing.startswith(PREFIX) \
                else "python"
            gaps[f"{phase}: {what}"] += (g1 - g0) * 1e-9
    return DeviceTrace(ops=ops, gaps=dict(gaps), jobs=jobs,
                       window_s=window_s)


def _idle(ops: List[DeviceOp], lo: int, hi: int) -> List[Tuple[int, int]]:
    """Stretches of [lo, hi) in which no operation of ``ops`` ran."""
    out, reach = [], lo
    for op in sorted(ops, key=lambda o: o.start_ns):
        if op.start_ns > reach:
            out.append((reach, min(op.start_ns, hi)))
        reach = max(reach, op.end_ns)
        if reach >= hi:
            break
    if reach < hi:
        out.append((reach, hi))
    return [(a, b) for a, b in out if b > a]


class _Nest:
    """Properly nested host intervals (one thread): the innermost one
    open at a time, found by walking down from the outermost."""

    def __init__(self, spans: List[Tuple[int, int, str]]):
        spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.root: list = [None, None, None, [], []]
        stack: List[list] = [self.root]
        for start, end, name in spans:
            node = [start, end, name, [], []]
            while len(stack) > 1 and stack[-1][1] <= start:
                stack.pop()
            stack[-1][3].append(node)
            stack[-1][4].append(start)
            stack.append(node)

    def at(self, t: int) -> Optional[str]:
        node, found = self.root, None
        while node[3]:
            i = bisect.bisect_right(node[4], t) - 1
            if i < 0 or node[3][i][1] <= t:
                break
            node = node[3][i]
            found = node[2]
        return found
