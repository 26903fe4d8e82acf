"""The readers that lay the program's spans beside the device trace, by
hand on spans and operations stamped on one clock, and the scale-8 CPU
cells traced."""
import pytest

from smallbench import small_registry
from graphbench import harness, profiling
from graphbench.registry import Registry

IDLE = ("edge_pass_idle_pct", "sketch_build_idle_pct",
        "clique_pass_idle_pct")
DEVICE_READERS = IDLE + ("clique_pass_syncs",)


def _span(name, t0, t1, enqueue_us=None, **args):
    ev = {"name": name, "t0_ns": t0, "t1_ns": t1, "ts": t0 * 1e-3,
          "dur": (t1 - t0) * 1e-3, "tid": 1, "parent": None, "depth": 0,
          "args": args}
    if enqueue_us is not None:
        ev["enqueue_us"] = enqueue_us
    return ev


def _trace(spans, ops, jobs=2):
    device = (None if ops is None else profiling.DeviceTrace(
        ops=[profiling.DeviceOp(name, a, b, None) for name, a, b in ops],
        gaps={}, jobs=jobs, window_s=1.0))
    return harness.TraceData(
        config={}, n=4, m=3, rows_named=3, csr_build_s=0.0, phase_ms={},
        spans=spans, device=device, job_counters=[])


#: one profiled job: the build [0, 1000), the edge pass [1000, 2000), the
#: clique pass [3000, 5000) (ns); an edge pass of another job far later
SPANS = [
    _span("sketch.build", 0, 1000, 900.0, kind="bf", n=4, width=4),
    _span("engine.edge_cards", 1000, 2000, 0.6, edges=3, chunks=3),
    _span("clique.count", 3000, 5000, 1.5, k=4, kind="bf"),
    _span("engine.edge_cards", 10**6, 2 * 10**6, 0.3, edges=3, chunks=3),
    _span("engine.edge_cards", 3 * 10**6, 4 * 10**6, 0.9, edges=3,
          chunks=3),
]
OPS = [
    ("kernel_a", 100, 400), ("kernel_b", 300, 600),        # build: 500 busy
    ("kernel_c", 1750, 2500),                              # edges: 250
    ("kernel_d", 3000, 3500),                              # cliques: 800
    ("Memcpy DtoH (Device -> Pinned)", 3600, 3700),
    ("Memcpy DtoH (Device -> Pageable)", 4000, 4100),
    ("Memcpy HtoD (Pageable -> Device)", 4200, 4300),
    ("Memcpy DtoH (Device -> Pinned)", 6000, 6100),        # outside
]


@pytest.mark.parametrize("name, want", [
    ("sketch_build_idle_pct", 50.0), ("edge_pass_idle_pct", 75.0),
    ("clique_pass_idle_pct", 60.0), ("clique_pass_syncs", 1.0),
    ("edge_dispatch_us_per_chunk", 0.2)])
def test_reader_on_a_hand_built_trace(name, want):
    """Idle shares clip the operations to the profiled job's spans and
    count overlapping operations once; the spans of other jobs, which
    overlap no operation, are left out. Two device-to-host copies ran
    inside the clique pass, over 2 jobs. The dispatch reads every job's
    edge pass: median of 0.2, 0.1 and 0.3 µs a chunk."""
    got = Registry.load().metric(name).read(_trace(SPANS, OPS))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("ops", [None, []])
def test_no_device_operations_reads_nothing(ops):
    """The CPU case: no device trace, or one without operations."""
    reg = Registry.load()
    t = _trace(SPANS, ops)
    for name in DEVICE_READERS:
        assert reg.metric(name).read(t) is None
    assert reg.metric("edge_dispatch_us_per_chunk").read(t) == \
        pytest.approx(0.2)


def test_spans_without_epoch_stamps_read_nothing():
    """Spans stamped on a clock of their own, with no ``t0_ns`` and no
    fence stamp, as a program without them records: nothing to read."""
    reg = Registry.load()
    old = [{"name": ev["name"], "ts": 5.0, "dur": ev["dur"], "tid": 1,
            "parent": None, "depth": 0, "args": {"edges": 3}}
           for ev in SPANS]
    t = _trace(old, OPS)
    for name in DEVICE_READERS + ("edge_dispatch_us_per_chunk",):
        assert reg.metric(name).read(t) is None


@pytest.mark.parametrize("cell", ["small_kron24_bf.tc_lcc",
                                  "small_kron24_kh.tc_lcc"])
def test_cpu_cell_traced_reports_dispatch(tmp_path, cell):
    reg = small_registry(tmp_path)
    out = harness.run_cell(cell, 2 ** 32 + 7, 0.3, True, registry=reg,
                           device="cpu", log=lambda m: None)
    assert out["correct"], out["checks"]
    got = out["metrics"]["edge_dispatch_us_per_chunk"]
    assert got["unit"] == "us" and got["value"] > 0
    for name in IDLE:
        assert name not in out["metrics"]
