"""At small scale on the CPU the plain reference equals the program's
plain path (``use_kernel=False``): the CSR, the sketches and every count
exactly, the floating-point answers to float32 rounding."""
import pytest
import torch

from smallbench import small_registry
from graphbench import generator, harness
from graphbench.reference import counts, graph as ref_graph, sketches


@pytest.mark.parametrize("cell,scale", [
    ("small_kron24_bf.tc_lcc", 12), ("small_kron24_kh.tc_lcc", 12),
    ("small_kron21_bf.cliques4", 10)])
def test_reference_equals_the_plain_path(tmp_path, cell, scale):
    reg = small_registry(tmp_path, scale)
    out = harness.run_cell(cell, 2 ** 31 + 17, 0.5, False, registry=reg,
                           device="cpu", log=lambda m: None)
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        if name.endswith("_diff"):
            assert c["value"] == 0, name
        else:       # float32 answers against the float64 reference
            assert c["value"] < 1e-5, (name, c["value"])


def test_sketches_equal_the_programs():
    from repro_torch.core.graph import from_edge_array
    from repro_torch.core import sketches as port

    cfg = {"generator": "graph500_kronecker", "scale": 9, "edge_factor": 8,
           "a": 0.57, "b": 0.19, "c": 0.19, "graph_seed": 5}
    raw = generator.kronecker_edges(cfg, 31, "cpu")
    rg = ref_graph.build(512, raw)
    g = from_edge_array(512, raw.numpy(), device="cpu")
    for seed in (0, 7, 2 ** 31 - 1):
        assert torch.equal(sketches.bloom(rg, 6, 3, seed),
                           port.build_bloom(g, 6, 3, seed))
        assert torch.equal(sketches.khash(rg, 9, seed),
                           port.build_khash(g, 9, seed))
    assert sketches.bloom_words(rg.n, rg.m, 1.0) == \
        port.bloom_words_for_budget(g.n, g.m, 1.0)
    assert sketches.khash_k(rg.n, rg.m, 1.0) == \
        port.minhash_k_for_budget(g.n, g.m, 1.0)


def test_popcount_counts_every_bit():
    x = torch.randint(-2 ** 31, 2 ** 31, (500, 37), dtype=torch.int64).to(
        torch.int32)
    want = torch.tensor([[bin(v & 0xFFFFFFFF).count("1") for v in row]
                         for row in x.tolist()]).sum(-1)
    assert torch.equal(counts.popcount_rows(x), want)
    assert counts.popcount_rows(torch.full((2, 32), -1, dtype=torch.int32)
                                ).tolist() == [1024, 1024]
