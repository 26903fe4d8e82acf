"""A cell over k cards runs as k ranks (gloo on the CPU here): the inputs
split by rank, the reference's range graphs, one result with the same
jobs on every rank and the checks worst over the ranks, and no rank left
behind when one fails. A cell of one card starts no process group."""
import os
import time

import pytest
import torch
import torch.distributed as dist

from smallbench import rank_registry, small_registry
from graphbench import calibrate, generator, harness, ranks
from graphbench.reference import graph as ref_graph

SEED = 2 ** 33 + 21
CONFIG = {"generator": "graph500_kronecker", "scale": 8, "edge_factor": 16,
          "a": 0.57, "b": 0.19, "c": 0.19, "graph_seed": 11}


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_shares_make_up_the_one_card_draw(world):
    raw = generator.kronecker_edges(CONFIG, SEED, "cpu")
    shares = [harness.edge_share(raw, world, r) for r in range(world)]
    assert torch.equal(torch.cat(shares), raw)
    sizes = [s.shape[0] for s in shares]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_vertex_ranges_are_the_programs(world):
    from repro_torch.launch import mine

    for n in (256, 255, 3):
        got = [harness.vertex_range(n, world, r) for r in range(world)]
        assert got == [mine.vertex_range(n, world, r) for r in range(world)]
        assert got[0][0] == 0 and got[-1][1] == n


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_build_range_is_build_sliced(world):
    n = 1 << CONFIG["scale"]
    raw = generator.kronecker_edges(CONFIG, SEED, "cpu")
    whole = ref_graph.build(n, raw)
    m = 0
    for r in range(world):
        lo, hi = harness.vertex_range(n, world, r)
        part = ref_graph.build_range(n, raw, lo, hi)
        first = int(whole.indptr[lo])
        assert (part.n, part.lo) == (n, lo)
        assert torch.equal(part.deg, whole.deg[lo:hi])
        assert torch.equal(part.indptr, whole.indptr[lo:hi + 1] - first)
        assert torch.equal(part.indices,
                           whole.indices[first:int(whole.indptr[hi])])
        u = whole.edges[:, 0]
        assert torch.equal(part.edges, whole.edges[(u >= lo) & (u < hi)])
        assert torch.equal(part.rows(), whole.rows()[
            first:int(whole.indptr[hi])])
        m += part.m
    assert m == whole.m


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_the_range_edges_of_the_shares_build_the_range(world):
    """What a rank checks against: the raw edges of every share that touch
    its range, in rank order, build the range as all the raw edges do."""
    n = 1 << CONFIG["scale"]
    raw = generator.kronecker_edges(CONFIG, SEED, "cpu")
    shares = [harness.edge_share(raw, world, r) for r in range(world)]
    for r in range(world):
        lo, hi = harness.vertex_range(n, world, r)
        edges = torch.cat([ref_graph.touching(s, lo, hi) for s in shares])
        assert edges.shape[0] < raw.shape[0] or world == 1
        want = ref_graph.build_range(n, raw, lo, hi)
        got = ref_graph.build_range(n, edges, lo, hi)
        for field in ("edges", "indptr", "indices", "deg"):
            assert torch.equal(getattr(got, field), getattr(want, field))


def _run(reg, cell, trace=False, **kw):
    return harness.run_cell(cell, SEED, 0.4, trace, registry=reg,
                            device="cpu", log=lambda m: None, **kw)


@pytest.mark.parametrize("world", [2, 4])
def test_a_cell_over_ranks_is_correct(tmp_path, world):
    reg, cell = rank_registry(tmp_path, world)
    out = _run(reg, cell)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"csr_diff", "sketch_diff", "tc_gap"}
    assert out["ranks"]["attempted"] == [out["attempted"]] * world
    assert out["attempted"] > 1
    assert out["device"]["count"] == world
    assert out["device"]["memory_peak_bytes"] == max(
        out["ranks"]["memory_peak_bytes"])
    # the rate counts the whole graph's edges, summed over the ranges
    m = ref_graph.build(1 << 8, generator.kronecker_edges(
        reg.config("small_kron8_bf"), SEED, "cpu")).m
    assert out["metrics"]["mined_edges_per_s"]["value"] > m
    assert list(out)[-1] == "checks"


def test_a_traced_cell_over_ranks_reads_every_ranks_trace(tmp_path):
    reg, cell = rank_registry(tmp_path, 2)
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "traced_ranks.py").write_text(
        'UNIT, LAYER, MOVES = "ranks", "device", "mined_edges_per_s"\n'
        "def read(data):\n"
        "    assert data.spans is data.rank_spans[0]\n"
        "    assert data.device is data.rank_devices[0]\n"
        "    return sum(d is not None for d in data.rank_devices)\n")
    reg.bench["per_layer"].append({
        "name": "traced_ranks", "unit": "ranks", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "mined_edges_per_s", "workloads": [cell]})
    out = _run(reg, cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["traced_ranks"]["value"] == 2
    assert out["metrics"]["csr_build_s"]["value"] > 0


def test_the_control_over_ranks_is_not_correct(tmp_path):
    reg, cell = rank_registry(tmp_path, 2)
    found = harness.run_control(cell, SEED, registry=reg, device="cpu")
    assert {c.name for c in found} == {"sketch_diff", "tc_gap"}
    assert not all(c.ok for c in found), found


def test_calibration_reads_the_ranks(tmp_path):
    reg, cell = rank_registry(tmp_path, 2)
    found = calibrate.program_readings(reg, cell, SEED, 2, "cpu")
    assert {c.name for c in found} == {"csr_diff", "sketch_diff", "tc_gap"}
    assert all(c.ok for c in found), found


@pytest.mark.parametrize("world,rank", [(2, 1), (4, 0)])
def test_a_fault_on_one_rank_is_not_correct(tmp_path, world, rank):
    reg, cell = rank_registry(tmp_path, world, traffic="mine_ranks_fault",
                              fault_rank=rank)
    out = _run(reg, cell)
    assert not out["correct"]
    assert out["checks"]["tc_gap"]["value"] > out["checks"]["tc_gap"][
        "limit"]


def _gone(pid_dir, world):
    """Every rank wrote its process id, and none of them runs."""
    pids = [int((pid_dir / f"rank{r}").read_text()) for r in range(world)]
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    return True


def test_a_rank_that_raises_leaves_no_result_and_no_rank(tmp_path):
    pid_dir = tmp_path / "pids"
    pid_dir.mkdir()
    reg, cell = rank_registry(tmp_path, 4, traffic="mine_ranks_raise",
                              raise_rank=2, pid_dir=str(pid_dir))
    with pytest.raises(ranks.RankFailure, match="planted failure on rank 2"):
        _run(reg, cell)
    assert _gone(pid_dir, 4)


def test_a_hung_rank_ends_at_the_deadline(tmp_path, monkeypatch):
    pid_dir = tmp_path / "pids"
    pid_dir.mkdir()
    reg, cell = rank_registry(tmp_path, 2, traffic="mine_ranks_hang",
                              hang_rank=1, pid_dir=str(pid_dir))
    monkeypatch.setattr(ranks, "DEADLINE_S", 10.0)
    t = time.monotonic()
    with pytest.raises(ranks.RankFailure, match="still running"):
        _run(reg, cell)
    assert time.monotonic() - t < 45
    assert _gone(pid_dir, 2)


def test_jax_loaded_on_a_rank_after_the_window_leaves_no_result(tmp_path):
    """A rank other than 0 loads ``flax`` in its check, after the window
    has closed: no result, and every rank ends."""
    pid_dir = tmp_path / "pids"
    pid_dir.mkdir()
    reg, cell = rank_registry(tmp_path, 2, traffic="mine_ranks_import",
                              import_rank=1, pid_dir=str(pid_dir))
    with pytest.raises(ranks.RankFailure, match="flax"):
        _run(reg, cell)
    assert _gone(pid_dir, 2)


def test_jax_loaded_by_a_reader_leaves_no_result(tmp_path):
    """Rank 0's per-layer reader loads ``jaxlib``: no result."""
    reg, cell = rank_registry(tmp_path, 2)
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "loads_jaxlib.py").write_text(
        'import sys, types\n'
        'UNIT, LAYER, MOVES = "n", "device", "mined_edges_per_s"\n'
        "def read(data):\n"
        '    sys.modules.setdefault("jaxlib", types.ModuleType("jaxlib"))\n'
        "    return 1\n")
    reg.bench["per_layer"].append({
        "name": "loads_jaxlib", "unit": "n", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "mined_edges_per_s", "workloads": [cell]})
    with pytest.raises(ranks.RankFailure, match="jaxlib"):
        _run(reg, cell, trace=True)


def test_a_job_kind_without_load_is_refused_over_ranks(tmp_path):
    reg = small_registry(tmp_path)
    reg.bench["workloads"].append({"name": "small_kron24_bf.tc_lcc_2",
                                   "config": "small_kron24_bf",
                                   "traffic": "tc_lcc", "chips": 2})
    with pytest.raises(ranks.RankFailure, match="load"):
        _run(reg, "small_kron24_bf.tc_lcc_2")


def test_a_one_card_cell_starts_no_group(tmp_path, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a cell of one card started ranks")
    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setattr(ranks, "launch", refuse)
    reg, cell = rank_registry(tmp_path, 1)
    out = _run(reg, cell)
    assert out["correct"], out["checks"]
    assert "ranks" not in out and out["device"]["count"] == 1
    assert not dist.is_initialized()
    found = harness.run_control(cell, SEED, registry=reg, device="cpu")
    assert not all(c.ok for c in found)
