"""On the GPU: each cell at a small scale through the kernel path, traced,
comes out correct and reports its per-layer metrics; the control does not
come out correct; the test job kind ``mine_ranks`` at scale 21 over 2 and
4 GPUs (NCCL) comes out correct. Skipped without the GPUs."""
import json

import pytest
import torch

from smallbench import rank_registry, small_registry
from graphbench import harness

CELLS = ["small_kron24_bf.tc_lcc", "small_kron24_kh.tc_lcc",
         "small_kron21_bf.cliques4"]


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel path has no CPU form)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_gpu(tmp_path, cell):
    _need_gpu()
    reg = small_registry(tmp_path, 14)
    out = harness.run_cell(cell, 2 ** 32 + 3, 1.0, True, registry=reg,
                           log=lambda m: None)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    want = {e["name"] for e in reg.metrics_of("per_layer", cell)}
    assert set(out["metrics"]) == want
    for name in ("and2_gather_roofline", "khash_gather_roofline",
                 "and3_segment_roofline"):
        if name in out["metrics"]:
            assert 0 < out["metrics"][name]["value"] <= 100


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_gpu(tmp_path, cell):
    _need_gpu()
    reg = small_registry(tmp_path, 14)
    found = harness.run_control(cell, 2 ** 32 + 5, registry=reg)
    assert not all(c.ok for c in found)


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_mine_ranks_over_nccl(tmp_path, world):
    """The harness's rank path on the cards: every rank runs the same
    jobs, and the checks, merged over the ranks, pass. Prints the result
    (``-s``)."""
    _need_gpu()
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA GPUs, one a rank")
    reg, cell = rank_registry(tmp_path, world, scale=21)
    for trace in (False, True):
        out = harness.run_cell(cell, 2 ** 32 + 7 + world, 10.0, trace,
                               registry=reg)
        print(json.dumps(out))
        assert out["correct"], out["checks"]
        assert out["ranks"]["attempted"] == [out["attempted"]] * world
        assert out["device"]["count"] == world
