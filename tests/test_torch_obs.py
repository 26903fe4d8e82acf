"""The port's span tracer (``repro_torch.obs.trace``): nesting, the
disabled path, the profiler annotations, the fence's enqueue stamp, the
epoch clock the profiler shares, and the Chrome-trace export.

Each test uses a tracer of its own, so none depends on the process-wide
one. The last test needs a CUDA GPU and skips without one.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import json
import time

import pytest
import torch

from repro_torch.obs import trace

#: how far two clocks may disagree: a span's and the profiler's, or the
#: span's and ``time.time_ns`` read beside it
SLACK_NS = 50_000


@pytest.fixture
def tracer():
    tr = trace.Tracer()
    tr.enable()
    return tr


@pytest.fixture
def annotations(monkeypatch):
    """Counts the ``torch.profiler.record_function`` objects made."""
    made = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        made.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return made


def _host_events(prof, names):
    """The profiler's host events of the given names, by name."""
    from torch.autograd import DeviceType
    return {ev.name(): ev for ev in prof.profiler.kineto_results.events()
            if ev.name() in names and ev.device_type() == DeviceType.CPU}


def test_nesting_records_parent_and_depth(tracer):
    with tracer.span("outer"):
        with tracer.span("middle"):
            with tracer.span("inner", x=1):
                pass
        with tracer.span("sibling"):
            pass
    got = {ev["name"]: (ev["parent"], ev["depth"], ev["args"])
           for ev in tracer.events()}
    assert got == {"outer": (None, 0, {}), "middle": ("outer", 1, {}),
                   "inner": ("middle", 2, {"x": 1}),
                   "sibling": ("outer", 1, {})}
    # completion order: children first
    assert [ev["name"] for ev in tracer.events()] == [
        "inner", "middle", "sibling", "outer"]


def test_disabled_path_is_the_null_span(monkeypatch, annotations):
    """Disabled, a span is the shared no-op object even while a profiler
    records: no annotation, no clock read, no synchronisation."""
    tr = trace.Tracer()

    class NoClock:
        def __getattr__(self, name):
            raise AssertionError(f"clock read: time.{name}")

    monkeypatch.setattr(trace, "time", NoClock())
    value = torch.ones(3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for opener in (tr.span, trace.span):
            sp = opener("x", k=1)
            assert sp is trace._NULL_SPAN
            with sp as inside:
                assert inside.fence(value) is value
                assert inside.set(k=2) is inside
    assert annotations == []
    assert tr.events() == [] and tr.recorded == 0


def test_no_annotation_without_a_recording_profiler(tracer, annotations):
    with tracer.span("a"):
        with tracer.span("b"):
            pass
    assert annotations == []
    assert [ev["name"] for ev in tracer.events()] == ["b", "a"]


def test_fence_stamps_the_enqueue(tracer):
    """``enqueue_us`` runs from the span's start to the fence call and
    ``dur`` on to the span's end: 0 <= enqueue_us <= dur."""
    with tracer.span("fenced") as sp:
        time.sleep(0.002)
        sp.fence(torch.ones(2))
        time.sleep(0.002)
    with tracer.span("unfenced"):
        pass
    fenced, unfenced = tracer.events()
    assert 0 <= fenced["enqueue_us"] <= fenced["dur"]
    assert fenced["enqueue_us"] >= 2000
    assert fenced["dur"] - fenced["enqueue_us"] >= 2000
    assert "enqueue_us" not in unfenced
    assert fenced["t1_ns"] - fenced["t0_ns"] == pytest.approx(
        fenced["dur"] * 1e3, abs=1)


def test_spans_are_stamped_on_the_epoch_clock(tracer):
    """``t0_ns``/``t1_ns`` are epoch nanoseconds (``time.time_ns``), and
    ``ts`` the same instant in µs; a clear takes a new anchor."""
    for _ in range(2):
        before = time.time_ns()
        with tracer.span("x"):
            time.sleep(0.001)
        after = time.time_ns()
        ev = tracer.events()[-1]
        assert isinstance(ev["t0_ns"], int) and isinstance(ev["t1_ns"], int)
        assert before - SLACK_NS <= ev["t0_ns"] < ev["t1_ns"] \
            <= after + SLACK_NS
        assert ev["ts"] == pytest.approx(ev["t0_ns"] * 1e-3, abs=1)
        tracer.clear()


def test_spans_show_in_the_profiler_trace(tracer, annotations):
    """Under a CPU ``torch.profiler``, each span is a host event of its
    name that lies inside [t0_ns, t1_ns], to within SLACK_NS: the span
    reads its clock outside the annotation at both ends, so only a clock
    that differs from the profiler's puts the event outside."""
    names = ("job", "job.build", "job.pass")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracer.span("job"):
            with tracer.span("job.build") as sp:
                torch.ones(1000).sum()
                time.sleep(0.001)
                sp.fence(torch.zeros(1))
            with tracer.span("job.pass"):
                time.sleep(0.001)
    assert sorted(annotations) == sorted(names)
    found = _host_events(prof, names)
    assert set(found) == set(names)
    for ev in tracer.events():
        host = found[ev["name"]]
        assert ev["t0_ns"] - SLACK_NS <= host.start_ns()
        assert host.start_ns() + host.duration_ns() <= ev["t1_ns"] + SLACK_NS


def test_export_schema(tracer, tmp_path):
    """Chrome trace events with µs ``ts`` counted from
    ``baseTimeNanoseconds`` (Kineto's rule: epoch seconds floored to a
    multiple of 7,889,238), parent, depth and the fence's stamp in
    ``args``; written to a path it loads back equal."""
    with tracer.span("outer", n=3):
        with tracer.span("inner") as sp:
            sp.fence(torch.ones(1))
    path = tmp_path / "spans.json"
    doc = tracer.export(str(path))
    assert json.loads(path.read_text()) == doc
    assert doc["displayTimeUnit"] == "ms"
    assert doc["otherData"] == {"recorded": 2, "capacity": tracer.capacity}
    base = doc["baseTimeNanoseconds"]
    assert base % (7889238 * 10**9) == 0
    events = {ev["name"]: ev for ev in tracer.events()}
    assert len(doc["traceEvents"]) == 2
    for out in doc["traceEvents"]:
        ev = events[out["name"]]
        assert set(out) == {"name", "cat", "ph", "ts", "dur", "pid", "tid",
                            "args"}
        assert out["ph"] == "X" and out["cat"] == "repro_torch"
        assert isinstance(out["pid"], int) and out["tid"] == 0
        assert 0 <= out["ts"] < 7889238 * 10**6
        assert abs(base + round(out["ts"] * 1e3) - ev["t0_ns"]) <= 2
        assert out["dur"] == pytest.approx(ev["dur"], abs=1e-3)
    args = {out["name"]: out["args"] for out in doc["traceEvents"]}
    assert args["outer"] == {"n": 3, "parent": None, "depth": 0}
    assert args["inner"]["parent"] == "outer" and args["inner"]["depth"] == 1
    assert 0 <= args["inner"]["enqueue_us"] <= events["inner"]["dur"]


@pytest.mark.cuda
def test_span_brackets_its_device_work_on_the_gpu(tracer):
    """On the card, a fenced span's device operations and its own
    annotation lie inside [t0_ns, t1_ns] of the profiler's clock, and the
    fence stamps the enqueue before the work ends."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from torch.autograd import DeviceType
    x = torch.randn(2048, 2048, device="cuda")
    (x @ x).sum().item()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        with tracer.span("gpu.work") as sp:
            y = x
            for _ in range(20):
                y = y @ x
            sp.fence(y)
    ev = tracer.events()[0]
    events = list(prof.profiler.kineto_results.events())
    device = [e for e in events if e.device_type() != DeviceType.CPU
              and not e.is_user_annotation()]
    assert device and not any(e.name() == "gpu.work" for e in device)
    for e in device:
        assert ev["t0_ns"] - SLACK_NS <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= ev["t1_ns"] + SLACK_NS
    host = _host_events(prof, ("gpu.work",))["gpu.work"]
    assert ev["t0_ns"] - SLACK_NS <= host.start_ns()
    last_end = max(e.start_ns() + e.duration_ns() for e in device)
    assert ev["t0_ns"] + ev["enqueue_us"] * 1e3 < last_end
