"""The byte and operation counts of the roofline metrics, by hand on a
tiny graph, and the shares they give."""
import pytest

from graphbench import harness, peaks, profiling
from graphbench.registry import Registry

# 4 vertices, 3 edges, 3 of the vertices with an edge; at s = 1.0 a Bloom
# row takes 4 words ((2·3 + 4 + 1)·32 / 4 = 88 bits -> 3 words -> even 4)
# and a k-Hash row k = max(4, floor(11 / 4)) = 4
N, M, ROWS = 4, 3, 3


def _trace(ops, counters=()):
    device = profiling.DeviceTrace(ops=ops, gaps={}, jobs=2, window_s=1.0)
    return harness.TraceData(
        config={"storage_budget": 1.0}, n=N, m=M, rows_named=ROWS,
        csr_build_s=0.0, phase_ms={}, spans=[], device=device,
        job_counters=list(counters))


def _op(name, seconds, phase=None):
    return profiling.DeviceOp(name, 0, int(seconds * 1e9), phase)


def test_and2_gather_counts():
    mod = Registry.load().metric("and2_gather_roofline")
    t = _trace([_op("tile_popcount_kernel<GatherSrc, 2, 4>", 2e-9)])
    # rows 3 × 4 words × 4 B, ids 2 × 4 B and a count 4 B per edge; per
    # edge and word an AND and an add, and a popcount
    assert mod.work(t) == (3 * 4 * 4 + 3 * 12, 3 * 4 * 2, 3 * 4)
    least = max(84 / peaks.HBM_BYTES_PER_S, 24 / peaks.INT32_OPS_PER_S,
                12 / peaks.POPC_PER_S)
    assert mod.read(t) == pytest.approx(100 * least / 1e-9)


def test_khash_gather_counts():
    mod = Registry.load().metric("khash_gather_roofline")
    t = _trace([_op("khash_kernel<GatherSrc, 8, 4>", 4e-9),
                _op("khash_kernel<RowsSrc, 8, 4>", 1.0)])
    assert mod.work(t) == (3 * 4 * 4 + 3 * 12, 3 * 4 * 2, 0)
    least = max(84 / peaks.HBM_BYTES_PER_S, 24 / peaks.INT32_OPS_PER_S)
    assert mod.read(t) == pytest.approx(100 * least / 2e-9)


def test_and3_segment_counts():
    mod = Registry.load().metric("and3_segment_roofline")
    t = _trace([_op("segment_popcount_kernel<3, 4, long>", 2e-6)],
               [{"triangles": 1000}, {"triangles": 3000}])
    # rows 3 × 4 words × 4 B, a tail id and a count per triangle (mean
    # 2,000 over the traced jobs); per triangle and word an AND and an
    # add, and a popcount
    assert mod.work(t) == (3 * 4 * 4 + 2000 * 8, 2000 * 4 * 2, 2000 * 4)
    least = max(16048 / peaks.HBM_BYTES_PER_S,
                16000 / peaks.INT32_OPS_PER_S, 8000 / peaks.POPC_PER_S)
    assert mod.read(t) == pytest.approx(100 * least / 1e-6)


def test_popcounts_bound_at_a_quarter_of_the_integer_rate():
    """sm_90 retires 16 popcounts a clock an SM against 64 adds: as many
    popcounts as adds take four times as long."""
    assert peaks.POPC_PER_S * 4 == pytest.approx(peaks.INT32_OPS_PER_S)
    assert peaks.least_seconds(0, 1e9, 1e9) == pytest.approx(
        1e9 / peaks.POPC_PER_S)
    assert peaks.roofline_percent((0, 0, 0), 0.0) is None


@pytest.mark.parametrize("name,kernel", [
    ("and2_gather_roofline", "tile_popcount_kernel<GatherSrc, 2, 4>"),
    ("khash_gather_roofline", "khash_kernel<GatherSrc, 8, 4>"),
    ("and3_segment_roofline", "segment_popcount_kernel<3, 4, long>")])
def test_over_ranks_a_roofline_reads_nothing(name, kernel):
    """Its work is the whole graph's and its time rank 0's."""
    mod = Registry.load().metric(name)
    t = _trace([_op(kernel, 2e-6)], [{"triangles": 1000}])
    assert mod.read(t) is not None
    t.world = 2
    assert mod.read(t) is None


def test_nothing_to_read_gives_nothing():
    reg = Registry.load()
    t = _trace([_op("some_other_kernel", 1e-3)], [{"triangles": 5}])
    for name in ("and2_gather_roofline", "khash_gather_roofline",
                 "and3_segment_roofline"):
        assert reg.metric(name).read(t) is None
    t.device = None
    for entry in reg.bench["per_layer"]:
        if entry["source"] == "device_trace" and entry["name"] != "build_ms":
            assert reg.metric(entry["name"]).read(t) is None
