"""Port parity, core layer: hashing, graphs, Bloom sketches, estimators.

Every input is made with numpy from a seed and handed to the JAX reference
(``repro``) and to the port (``repro_torch``, on the CPU). Integer results
(hashes, graph arrays, sketch words, popcounts) must be identical; float
estimates are held to ``rtol=1e-6`` because XLA's and torch's ``log1p``
may differ by an ulp.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import estimators as RE
from repro.core import graph as RG
from repro.core import hashing as RH
from repro.core import sketches as RS
from repro_torch import convert
from repro_torch.core import estimators as TE
from repro_torch.core import graph as TG
from repro_torch.core import hashing as TH
from repro_torch.core import sketches as TS

CPU = "cpu"

# keys around the sign bit and the uint32 wraparound, plus ordinary ones
KEYS = np.concatenate([
    np.arange(2048, dtype=np.int64),
    np.array([2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1],
             dtype=np.int64),
    np.random.default_rng(3).integers(0, 2**32, size=4096, dtype=np.int64),
])
SEEDS = (0, 1, 12345, 2**31, 2**32 - 1)


def _u32(x) -> np.ndarray:
    """int64 tensor holding uint32 values -> numpy int64."""
    return x.numpy().astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_u32_bit_identical(seed):
    """hash_u32 and its numpy twin equal the reference exactly (integers)."""
    ref = np.asarray(RH.hash_u32(jnp.asarray(KEYS.astype(np.uint32)), seed))
    got = _u32(TH.hash_u32(torch.from_numpy(KEYS), seed))
    assert np.array_equal(ref.astype(np.int64), got)
    assert np.array_equal(TH.np_hash_u32(KEYS.astype(np.uint32), seed), ref)
    assert np.array_equal(TH.np_hash_u32(KEYS.astype(np.uint32), seed),
                          RH.np_hash_u32(KEYS.astype(np.uint32), seed))


def test_fmix32_family_and_unit_interval_bit_identical():
    """fmix32, hash_family and hash_unit_interval match the reference."""
    x32 = KEYS.astype(np.uint32)
    assert np.array_equal(
        np.asarray(RH.fmix32(jnp.asarray(x32))).astype(np.int64),
        _u32(TH.fmix32(torch.from_numpy(KEYS))))
    assert np.array_equal(RH.np_fmix32(x32), TH.np_fmix32(x32))
    for seed in (0, 7, 2**32 - 1):
        fam_ref = np.asarray(RH.hash_family(jnp.asarray(x32), 3, seed))
        fam = _u32(TH.hash_family(torch.from_numpy(KEYS), 3, seed))
        assert np.array_equal(fam_ref.astype(np.int64), fam)
        unit_ref = np.asarray(RH.hash_unit_interval(jnp.asarray(x32), seed))
        unit = TH.hash_unit_interval(torch.from_numpy(KEYS), seed).numpy()
        assert np.array_equal(unit_ref, unit)


def test_negative_keys_wrap_like_uint32():
    """Negative int keys hash as their uint32 two's-complement value."""
    neg = np.array([-1, -2, -2**31], dtype=np.int64)
    assert np.array_equal(_u32(TH.hash_u32(torch.from_numpy(neg), 5)),
                          _u32(TH.hash_u32(torch.from_numpy(neg & 0xFFFFFFFF),
                                           5)))


def _assert_same_graph(rg, tg):
    for field in ("indptr", "indices", "deg", "edges"):
        ref = np.asarray(getattr(rg, field))
        got = getattr(tg, field).numpy()
        assert ref.dtype == got.dtype, field
        assert np.array_equal(ref, got), field
    assert (rg.n, rg.m, rg.d_max) == (tg.n, tg.m, tg.d_max)
    assert tg._adj is None, "adj must be built only on demand"
    assert np.array_equal(np.asarray(rg.adj), tg.adj.numpy())


@pytest.mark.parametrize("scale", [10, 11, 12])
def test_kronecker_array_identical(scale):
    """Kronecker graphs (seed 1) are array-identical, lazy adj included."""
    _assert_same_graph(RG.kronecker(scale, 16, seed=1),
                       TG.kronecker(scale, 16, seed=1, device=CPU))


def test_from_edge_array_and_erdos_renyi_identical():
    """Messy edge arrays (duplicates, both directions, self loops, out of
    range) canonicalize identically; padding and G(n, p) too."""
    rng = np.random.default_rng(11)
    raw = rng.integers(-3, 70, size=(600, 2))
    _assert_same_graph(RG.from_edge_array(64, raw),
                       TG.from_edge_array(64, raw, device=CPU))
    _assert_same_graph(RG.from_edge_array(64, raw, pad_to_max_degree=90),
                       TG.from_edge_array(64, raw, pad_to_max_degree=90,
                                          device=CPU))
    _assert_same_graph(RG.from_edge_array(0, np.zeros((0, 2))),
                       TG.from_edge_array(0, np.zeros((0, 2)), device=CPU))
    _assert_same_graph(RG.erdos_renyi(300, 0.05, seed=7),
                       TG.erdos_renyi(300, 0.05, seed=7, device=CPU))
    assert np.array_equal(RG.canonical_edge_keys(64, raw),
                          TG.canonical_edge_keys(64, raw))


def test_graph_view_and_host_helpers():
    """graph_view derives the same CSR; neighbors_np and the dense TC
    oracle agree with the reference."""
    rg = RG.kronecker(9, 8, seed=2)
    tg = TG.kronecker(9, 8, seed=2, device=CPU)
    view = TG.graph_view(tg.n, tg.m, tg.deg, tg.adj, tg.edges)
    assert torch.equal(view.indptr, tg.indptr)
    assert torch.equal(view.indices, tg.indices)
    assert view.adj is tg.adj
    for v in (0, 3, 100):
        assert np.array_equal(RG.neighbors_np(rg, v), TG.neighbors_np(tg, v))
    assert RG.triangle_count_dense(rg) == TG.triangle_count_dense(tg)


def test_convert_round_trip():
    """convert.graph_from_numpy / sketch_from_numpy carry reference state."""
    rg = RG.kronecker(9, 8, seed=4)
    tg = convert.graph_from_numpy(
        np.asarray(rg.indptr), np.asarray(rg.indices), np.asarray(rg.deg),
        np.asarray(rg.edges), rg.n, rg.m, rg.d_max, device=CPU)
    _assert_same_graph(rg, tg)
    rs = RS.build(rg, "bf", 0.5, num_hashes=3, seed=2)
    ts = convert.sketch_from_numpy(np.asarray(rs.data), "bf", 3, 0, 2, rg.n,
                                   device=CPU)
    assert ts.data.dtype == torch.int32
    assert np.array_equal(ts.data.numpy().view(np.uint32), np.asarray(rs.data))
    assert ts.total_bits == rs.total_bits


@pytest.fixture(scope="module")
def graphs():
    return RG.kronecker(10, 16, seed=1), TG.kronecker(10, 16, seed=1,
                                                     device=CPU)


@pytest.mark.parametrize("num_hashes", [1, 2, 3])
@pytest.mark.parametrize("budget", [0.05, 0.25, 1.0])
def test_build_bloom_bit_identical(graphs, num_hashes, budget):
    """Bloom words equal the reference's build_bloom and build_bloom_np."""
    rg, tg = graphs
    words = RS.bloom_words_for_budget(rg.n, rg.m, budget)
    assert words == TS.bloom_words_for_budget(tg.n, tg.m, budget)
    ref = np.asarray(RS.build_bloom(rg, words, num_hashes, seed=3))
    got = TS.build_bloom(tg, words, num_hashes, seed=3)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), ref)
    assert np.array_equal(RS.build_bloom_np(rg, words, num_hashes, seed=3),
                          ref)
    assert np.array_equal(TS.build_bloom_np(tg, words, num_hashes, seed=3),
                          ref)


def test_build_bloom_chunking_is_invisible(graphs):
    """Tiny chunks (one row at a time for hubs) give the same words."""
    _, tg = graphs
    whole = TS.build_bloom(tg, 8, 2, seed=1)
    for chunk_bits in (256, 4096, 1 << 16):
        assert torch.equal(TS.build_bloom(tg, 8, 2, seed=1,
                                          chunk_bits=chunk_bits), whole)


def test_sketch_set_build_and_unported_kinds(graphs):
    """build(..., "bf") matches the reference SketchSet; other kinds wait."""
    rg, tg = graphs
    rs = RS.build(rg, "bf", 0.25, num_hashes=2, seed=0)
    ts = TS.build(tg, "bf", 0.25, num_hashes=2, seed=0)
    assert (ts.kind, ts.num_hashes, ts.k, ts.seed, ts.n, ts.total_bits) == (
        rs.kind, rs.num_hashes, rs.k, rs.seed, rs.n, rs.total_bits)
    assert np.array_equal(ts.data.numpy().view(np.uint32), np.asarray(rs.data))
    for kind in ("kh", "1h", "kmv"):
        with pytest.raises(NotImplementedError):
            TS.build(tg, kind)
    with pytest.raises(ValueError):
        TS.build(tg, "nope")


def test_pack_unpack_bits_match_reference():
    """pack_bits/unpack_bits round-trip and match the reference's bits."""
    bits = np.random.default_rng(5).random((17, 96)) < 0.5
    ref = np.asarray(RS.pack_bits(jnp.asarray(bits)))
    got = TS.pack_bits(torch.from_numpy(bits))
    assert np.array_equal(got.numpy().view(np.uint32), ref)
    assert np.array_equal(TS.unpack_bits(got).numpy(), bits)


def test_swar_popcount_exact_with_top_bit():
    """The SWAR popcount is exact on every word, top bit set or not."""
    rng = np.random.default_rng(9)
    words = np.concatenate([
        rng.integers(0, 2**32, size=(500, 7), dtype=np.uint64).astype(np.uint32),
        np.array([[0, 1, 2**31, 2**32 - 1, 0x80000001, 0x7FFFFFFF, 0xAAAAAAAA]],
                 dtype=np.uint32)])
    want = np.unpackbits(words.view(np.uint8), axis=-1).sum(-1)
    got = TE._popcount_words(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    ref = np.asarray(RE._popcount_words(jnp.asarray(words)))
    assert np.array_equal(got.numpy(), ref)


def test_bloom_estimators_match_reference():
    """Swamidass size, AND, limit and OR estimators: rtol=1e-6 (ulp-level
    log1p differences between XLA and torch); from_ones on the same ints.
    The OR estimate is a difference |X|+|Y|-|X∪Y|, so an ulp of its
    operands shows as absolute error: it also gets atol = 1e-6 × the
    operands' magnitude."""
    rng = np.random.default_rng(2)
    x = rng.integers(0, 2**32, size=(300, 8), dtype=np.uint64).astype(np.uint32)
    y = rng.integers(0, 2**32, size=(300, 8), dtype=np.uint64).astype(np.uint32)
    x[0] = 0xFFFFFFFF                    # a full row hits the divergence fix
    y[0] = 0xFFFFFFFF
    xt = torch.from_numpy(x.view(np.int32))
    yt = torch.from_numpy(y.view(np.int32))
    sx = torch.from_numpy(rng.integers(1, 100, size=300).astype(np.int32))
    sy = torch.from_numpy(rng.integers(1, 100, size=300).astype(np.int32))
    for b in (1, 2, 3):
        union_ref = np.asarray(RE.bf_size_swamidass(
            jnp.asarray(x | y), b))
        or_atol = 1e-6 * float(np.abs(union_ref).max())
        ones = np.arange(0, 300, dtype=np.int32)
        pairs = [
            (RE.bf_size_swamidass(jnp.asarray(x), b),
             TE.bf_size_swamidass(xt, b), 1e-6),
            (RE.bf_intersection_and(jnp.asarray(x), jnp.asarray(y), b),
             TE.bf_intersection_and(xt, yt, b), 1e-6),
            (RE.bf_intersection_limit(jnp.asarray(x), jnp.asarray(y), b),
             TE.bf_intersection_limit(xt, yt, b), 1e-6),
            (RE.bf_intersection_or(jnp.asarray(x), jnp.asarray(y), b,
                                   jnp.asarray(sx.numpy()),
                                   jnp.asarray(sy.numpy())),
             TE.bf_intersection_or(xt, yt, b, sx, sy), or_atol),
            (RE.bf_intersection_and_from_ones(jnp.asarray(ones), 256, b),
             TE.bf_intersection_and_from_ones(torch.from_numpy(ones), 256, b),
             1e-6),
        ]
        for ref, got, atol in pairs:
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-6, atol=atol)
