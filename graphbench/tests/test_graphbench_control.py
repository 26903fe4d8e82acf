"""The comparison that decides ``correct`` rejects what it must.

The control (the reference computed in bfloat16, put in the program's
place) comes out not correct in every cell. And a run whose timed path is
broken underneath comes out not correct, once for each fault a cell of one
GPU can have: a job that returns the state of the one before (its sketch
kept, the new seed ignored); half of the work left out and the mean taken
over the rest; an answer altered where it is produced. (The exchange
between chips does not exist on one chip.)
"""
import pytest
import torch

from graphbench import calibrate, harness

CELLS = ["small_kron24_bf.tc_lcc", "small_kron24_kh.tc_lcc",
         "small_kron21_bf.cliques4"]


def _run(reg, cell):
    return harness.run_cell(cell, 4_000_000_007, 0.4, False, registry=reg,
                            device="cpu", log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(small, cell):
    assert _run(small, cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_calibration_reads_sound_runs(small, cell):
    found = calibrate.program_readings(small, cell, 4_000_000_009, 2, "cpu")
    assert all(c.ok for c in found), found


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(small, cell):
    found = harness.run_control(cell, 4_000_000_011, registry=small,
                                device="cpu")
    assert not all(c.ok for c in found), found


def _stale(monkeypatch):
    """Every session after the first gets the first session's sketch."""
    from repro_torch.engine import engine

    first = []
    build = engine.build_sketch

    def stale(*args, **kw):
        if not first:
            first.append(build(*args, **kw))
        return first[0]
    monkeypatch.setattr(engine, "build_sketch", stale)


def _half_cards(monkeypatch):
    """The per-edge pass computes the first half of the edges and gives
    the rest the mean of that half."""
    from repro_torch.engine import engine

    full = engine.edge_cardinalities

    def half(graph, sketch, plan, edges=None):
        edges = graph.edges if edges is None else edges
        k = edges.shape[0] // 2
        head = full(graph, sketch, plan, edges[:k])
        return torch.cat([head, head.mean().expand(edges.shape[0] - k)])
    monkeypatch.setattr(engine, "edge_cardinalities", half)


def _altered_card(monkeypatch):
    """One edge's cardinality is raised by one where it is produced."""
    from repro_torch.engine import engine

    full = engine.edge_cardinalities

    def altered(*args, **kw):
        cards = full(*args, **kw).clone()
        cards[cards.numel() // 2] += 1.0
        return cards
    monkeypatch.setattr(engine, "edge_cardinalities", altered)


def _half_tuples(monkeypatch):
    """The clique popcounts of each launch's second half are replaced by
    the mean of its first half."""
    from repro_torch import engine

    full = engine.segment_cardinality_ones

    def half(*args):
        ones = full(*args)
        k = ones.numel() // 2
        if k:
            ones[k:] = ones[:k].to(torch.float64).mean().round().to(
                ones.dtype)
        return ones
    monkeypatch.setattr(engine, "segment_cardinality_ones", half)


def _altered_tuple(monkeypatch):
    """One clique popcount of each launch is raised by one."""
    from repro_torch import engine

    full = engine.segment_cardinality_ones

    def altered(*args):
        ones = full(*args)
        if ones.numel():
            ones[0] += 1
        return ones
    monkeypatch.setattr(engine, "segment_cardinality_ones", altered)


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in CELLS[:2]
    for fault in (_stale, _half_cards, _altered_card)] + [
    (CELLS[2], fault) for fault in (_stale, _half_tuples, _altered_tuple)])
def test_broken_timed_path_is_not_correct(small, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = _run(small, cell)
    assert not out["correct"], out["checks"]
