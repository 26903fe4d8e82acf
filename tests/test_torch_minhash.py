"""Port parity, second slice: MinHash and KMV sketches, their match counts
and estimators, Jarvis–Patrick clustering and the cardinality similarities.

Inputs are made with numpy from a seed (``kronecker(10, 16, seed=1)`` and
a graph with isolated vertices) and go through the JAX reference and the
port on the CPU (the plain PyTorch path of every kernel). Tolerances:

  * identical: k-Hash / 1-Hash / KMV sketches, 1-Hash hash values, the
    MinHash match counts (against the reference's Pallas kernels in
    interpret mode and its ``kernels/ref.py``), connected-component labels
    given the same kept-edge mask;
  * ``rtol=1e-6``: estimators and per-edge estimates (float32 arithmetic
    in the same order; XLA's and torch's ``log1p`` may differ by an ulp on
    the Bloom path);
  * ``rtol=1e-5, atol=1e-6``: TC and LCC (float32 sums in another order);
  * Bloom similarities ``rtol=1e-5``: a ratio of two estimates, each
    within an ulp-level ``rtol`` of the reference's.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import engine as RE
from repro.core import estimators as RES
from repro.core import graph as RG
from repro.core import hashing as RH
from repro.core import sketches as RS
from repro.core.algorithms import clustering as RCL
from repro.core.algorithms import similarity as RSIM
from repro.kernels import ops as RO
from repro.kernels import ref as RR
from repro.launch import mine as RM
from repro_torch import convert
from repro_torch import engine as TE
from repro_torch.core import estimators as TES
from repro_torch.core import graph as TG
from repro_torch.core import sketches as TS
from repro_torch.core.algorithms import clustering as TCL
from repro_torch.core.algorithms import similarity as TSIM
from repro_torch.kernels import mh_intersect as TMH
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.launch import mine as TM

CPU = "cpu"
KINDS = ("kh", "1h", "kmv")
MEASURES = ("jaccard", "overlap", "common", "total")

#: hash_u32(QUIRK_ID, QUIRK_SEED) == 0xFFFFFFFF (found by inverting fmix32)
QUIRK_SEED, QUIRK_ID = 120159072, 97

#: (kind, plan options): the four MinHash/KMV configurations of a session
CONFIGS = {"kh": ("kh", {}), "1h": ("1h", {}),
           "1h-naive": ("1h", {"variant": "naive"}), "kmv": ("kmv", {}),
           "bf": ("bf", {})}


def _isolated_edges() -> np.ndarray:
    """Edges among the first 200 of 300 vertices (100 isolated), and the
    quirk vertex joined to three vertices of degree 1."""
    rng = np.random.default_rng(0)
    e = rng.integers(0, 200, size=(500, 2))
    return np.concatenate([e, [[QUIRK_ID, 250], [QUIRK_ID, 251],
                               [QUIRK_ID, 252]]])


@pytest.fixture(scope="module")
def graphs():
    e = _isolated_edges()
    return {
        "kron": (RG.kronecker(10, 16, seed=1),
                 TG.kronecker(10, 16, seed=1, device=CPU)),
        "iso": (RG.from_edge_array(300, e),
                TG.from_edge_array(300, e, device=CPU)),
    }


@pytest.fixture(scope="module")
def sessions(graphs):
    """Reference and port sessions on the Kronecker graph, per config."""
    rg, tg = graphs["kron"]
    out = {}
    for name, (kind, kw) in CONFIGS.items():
        out[name] = (RE.session(rg, kind, storage_budget=1.0, **kw),
                     TE.session(tg, kind, storage_budget=1.0, device=CPU,
                                **kw))
    return out


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ----------------------------------------------------------------------------
# sketches
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("s", [0.05, 0.25, 1.0, 3.0])
def test_minhash_k_for_budget_matches_reference(s):
    """The budget -> k rule is the reference's over a grid of (n, m)."""
    for n in (1, 7, 1024, 2 ** 21):
        for m in (0, 5, 10_501, 31_768_958):
            for min_k in (1, 4):
                assert TS.minhash_k_for_budget(n, m, s, min_k) == \
                    RS.minhash_k_for_budget(n, m, s, min_k)


@pytest.mark.parametrize("k", [4, 7, 31])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("graph", ["kron", "iso"])
def test_builders_array_identical(graphs, graph, kind, k):
    """build_khash / build_1hash / build_kmv equal the JAX builders, also
    with chunks of a few rows (d_max < k on the isolated-vertex graph)."""
    rg, tg = graphs[graph]
    builder = {"kh": "build_khash", "1h": "build_1hash", "kmv": "build_kmv"}
    ref = np.asarray(getattr(RS, builder[kind])(rg, k, 3))
    got = getattr(TS, builder[kind])(tg, k, 3)
    assert got.dtype == {"kh": torch.int32, "1h": torch.int32,
                         "kmv": torch.float32}[kind]
    assert got.shape == ref.shape
    assert np.array_equal(got.numpy(), ref)
    small = getattr(TS, builder[kind])(tg, k, 3, chunk_candidates=3 * k)
    assert torch.equal(small, got)


def test_onehash_values_identical(graphs):
    """Hash values of a 1-Hash sketch (pads -> PAD_HASH) are the reference's."""
    rg, tg = graphs["kron"]
    r = RS.build(rg, "1h", 0.5, seed=5)
    t = TS.build(tg, "1h", 0.5, seed=5)
    ref = np.asarray(RS.onehash_values(r.data, rg.n, 5)).astype(np.int64)
    got = TS.onehash_values(t.data, tg.n, 5)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), ref)
    assert TS.PAD_HASH == int(RS.PAD_HASH) and TS.KMV_PAD == float(RS.KMV_PAD)


def test_onehash_pad_hash_quirk_copied(graphs):
    """A valid element whose hash is 0xFFFFFFFF becomes the sentinel in the
    reference's 1-Hash rows; the port copies that."""
    rg, tg = graphs["iso"]
    h = RH.np_hash_u32(np.array([QUIRK_ID]), QUIRK_SEED)
    assert int(h[0]) == 0xFFFFFFFF
    ref = np.asarray(RS.build_1hash(rg, 4, QUIRK_SEED))
    got = TS.build_1hash(tg, 4, QUIRK_SEED).numpy()
    assert np.array_equal(got, ref)
    # vertex 250's only neighbour is the quirk vertex: its row is all pads
    assert got[250].tolist() == [tg.n] * 4
    assert QUIRK_ID in TS.build_khash(tg, 4, QUIRK_SEED).numpy()[250]


def test_build_width_when_d_max_below_k():
    """1-Hash and KMV keep min(k, d_max) columns, as the reference's
    row builder gives them. With more than 4096 vertices the reference's
    chunked build fails on that width (a reference fault); the port's rows
    equal the reference's row builder applied chunk by chunk."""
    rng = np.random.default_rng(1)
    e = rng.integers(0, 5000, size=(6000, 2))
    rg = RG.from_edge_array(5000, e)
    tg = TG.from_edge_array(5000, e, device=CPU)
    assert rg.d_max < 31
    for kind, rows_fn, build in (("1h", RS.onehash_rows, TS.build_1hash),
                                 ("kmv", RS.kmv_rows, TS.build_kmv)):
        with pytest.raises(TypeError):
            RS.build(rg, kind, k=31)
        got = build(tg, 31).numpy()
        ref = np.concatenate([
            np.asarray(rows_fn(rg.adj[s:s + 4096], rg.n, 31))
            for s in range(0, rg.n, 4096)])
        assert got.shape == (5000, rg.d_max)
        assert np.array_equal(got, ref)


def test_sketch_sets_and_convert(graphs):
    """build(...) fields match the reference; sketch_from_numpy carries
    int32 and float32 sketches and refuses the wrong type."""
    rg, tg = graphs["kron"]
    for kind in KINDS:
        r = RS.build(rg, kind, 0.25, seed=2)
        t = TS.build(tg, kind, 0.25, seed=2)
        assert (t.kind, t.num_hashes, t.k, t.seed, t.n, t.total_bits) == (
            r.kind, r.num_hashes, r.k, r.seed, r.n, r.total_bits)
        c = convert.sketch_from_numpy(np.asarray(r.data), kind, r.num_hashes,
                                      r.k, r.seed, r.n, device=CPU)
        assert c.data.dtype == t.data.dtype and torch.equal(c.data, t.data)
    with pytest.raises(ValueError, match="float32"):
        convert.sketch_from_numpy(np.zeros((2, 3), np.int32), "kmv", 0, 3, 0,
                                  2, device=CPU)
    with pytest.raises(ValueError, match="int32"):
        convert.sketch_from_numpy(np.zeros((2, 3), np.float32), "kh", 0, 3, 0,
                                  2, device=CPU)


# ----------------------------------------------------------------------------
# the two MinHash counts
# ----------------------------------------------------------------------------

def _count_rows(rng, e: int, k: int, sentinel: int):
    """Sentinel-heavy rows with negative ids and duplicates; b shares
    about half of a's positions; every 5th row of a is all sentinel."""
    a = rng.integers(-20, sentinel + 20, size=(e, k)).astype(np.int32)
    b = rng.integers(-20, sentinel + 20, size=(e, k)).astype(np.int32)
    b = np.where(rng.random((e, k)) < 0.5, a, b).astype(np.int32)
    a[::5] = sentinel
    return a, b


@pytest.mark.parametrize("k", [1, 4, 31, 64])
@pytest.mark.parametrize("e", [0, 1, 7, 1000])
def test_minhash_counts_identical_to_reference(e, k):
    """ref.py, ops and the wrapper's CPU path equal the reference's
    kernels/ref.py and its Pallas kernels in interpret mode (the
    reference's padded ops raise ZeroDivisionError at E = 0; the port
    returns an empty count)."""
    rng = np.random.default_rng(e * 100 + k)
    sentinel = 60
    a, b = _count_rows(rng, e, k, sentinel)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("mh_intersect_pairs", "khash_match_pairs"):
        want = np.asarray(getattr(RR, name)(jnp.asarray(a), jnp.asarray(b),
                                            sentinel))
        if e:
            pallas = np.asarray(getattr(RO, name)(jnp.asarray(a),
                                                  jnp.asarray(b), sentinel))
            assert np.array_equal(pallas, want)
        else:
            with pytest.raises(ZeroDivisionError):
                getattr(RO, name)(jnp.asarray(a), jnp.asarray(b), sentinel)
        before = dict(TMH.LAUNCHES)
        for got in (getattr(TR, name)(ta, tb, sentinel),
                    getattr(TO, name)(ta, tb, sentinel),
                    getattr(TO, name)(ta, tb, sentinel, use_kernel=False),
                    getattr(TMH, name)(ta, tb, sentinel)):
            assert got.dtype == torch.int32 and got.shape == (e,)
            assert np.array_equal(got.numpy(), want)
        assert TMH.LAUNCHES == before


def test_minhash_counts_semantics():
    """Duplicates count with multiplicity, negatives are valid, the plain
    version's chunking is invisible, and use_kernel=True needs CUDA."""
    a = torch.tensor([[3, 3, -2, 9], [9, 9, 9, 9]], dtype=torch.int32)
    b = torch.tensor([[3, -2, 3, 7], [9, 9, 9, 9]], dtype=torch.int32)
    assert TO.mh_intersect_pairs(a, b, 9).tolist() == [5, 0]
    assert TO.khash_match_pairs(a, b, 9).tolist() == [1, 0]
    assert TO.mh_intersect_pairs(a, b, 10).tolist() == [5, 16]
    rng = np.random.default_rng(3)
    x, y = (torch.from_numpy(r) for r in _count_rows(rng, 700, 33, 40))
    whole = TR.mh_intersect_pairs(x, y, 40)
    old = TR._MH_CHUNK_CELLS
    try:
        TR._MH_CHUNK_CELLS = 33 * 33 * 7
        assert torch.equal(TR.mh_intersect_pairs(x, y, 40), whole)
    finally:
        TR._MH_CHUNK_CELLS = old
    with pytest.raises(ValueError, match="needs CUDA"):
        TO.khash_match_pairs(a, b, 9, use_kernel=True)
    with pytest.raises(ValueError, match="needs CUDA"):
        TO.mh_intersect_pairs(a, b, 9, use_kernel=True)


# ----------------------------------------------------------------------------
# estimators
# ----------------------------------------------------------------------------

def _pair_rows(sess_r, sess_t, rng, p=400):
    """Sketch rows and degrees of random vertex pairs (both sides)."""
    rg_n = sess_t.graph.n
    pairs = rng.integers(0, rg_n, size=(p, 2)).astype(np.int32)
    rdata, tdata = np.asarray(sess_r.sketch.data), sess_t.sketch.data
    deg = np.asarray(sess_r.graph.deg)
    ru, rv = rdata[pairs[:, 0]], rdata[pairs[:, 1]]
    du, dv = deg[pairs[:, 0]], deg[pairs[:, 1]]
    t = tdata[torch.from_numpy(pairs[:, 0]).long()], \
        tdata[torch.from_numpy(pairs[:, 1]).long()]
    return (ru, rv, du, dv), (t[0], t[1], torch.from_numpy(du),
                              torch.from_numpy(dv))


def _close(got, ref, rtol=1e-6, atol=0.0):
    got = _np(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def test_khash_and_onehash_estimators_match_reference(sessions):
    """Every MinHash estimator and helper, on real sketch rows of random
    vertex pairs, flat and with a leading batch axis: rtol 1e-6."""
    rng = np.random.default_rng(11)
    for name in ("kh", "1h"):
        rs, ts = sessions[name]
        (ru, rv, du, dv), (tu, tv, tdu, tdv) = _pair_rows(rs, ts, rng)
        n = rs.sketch.n
        R = lambda x: jnp.asarray(x)  # noqa: E731
        if name == "kh":
            _close(TES.khash_jaccard(tu, tv, n),
                   RES.khash_jaccard(R(ru), R(rv), n))
            _close(TES.khash_intersection(tu, tv, tdu, tdv, n),
                   RES.khash_intersection(R(ru), R(rv), R(du), R(dv), n))
            _close(TES.khash_jaccard(tu.reshape(20, 20, -1),
                                     tv.reshape(20, 20, -1), n),
                   RES.khash_jaccard(R(ru).reshape(20, 20, -1),
                                     R(rv).reshape(20, 20, -1), n))
            continue
        hu = TS.onehash_values(tu, n, 0)
        hv = TS.onehash_values(tv, n, 0)
        rhu = RS.onehash_values(R(ru), n, 0)
        rhv = RS.onehash_values(R(rv), n, 0)
        assert np.array_equal(
            TES._sorted_intersect_count(tu, tv, n).numpy(),
            np.asarray(RES._sorted_intersect_count(R(ru), R(rv), n)))
        assert np.array_equal(TES._pairwise_dup_mask(tu, tv, n).numpy(),
                              np.asarray(RES._pairwise_dup_mask(R(ru), R(rv),
                                                                n)))
        assert np.array_equal(TES._membership(tu, tv, n).numpy(),
                              np.asarray(RES._membership(R(ru), R(rv), n)))
        _close(TES.onehash_jaccard_naive(tu, tv, n),
               RES.onehash_jaccard_naive(R(ru), R(rv), n))
        _close(TES.onehash_jaccard_union(tu, tv, hu, hv, n),
               RES.onehash_jaccard_union(R(ru), R(rv), rhu, rhv, n))
        for variant in ("union", "naive"):
            _close(TES.onehash_intersection(tu, tv, hu, hv, tdu, tdv, n,
                                            variant),
                   RES.onehash_intersection(R(ru), R(rv), rhu, rhv, R(du),
                                            R(dv), n, variant))
        _close(TES.onehash_jaccard_union(
                   tu.reshape(20, 20, -1), tv.reshape(20, 20, -1),
                   hu.reshape(20, 20, -1), hv.reshape(20, 20, -1), n),
               RES.onehash_jaccard_union(
                   R(ru).reshape(20, 20, -1), R(rv).reshape(20, 20, -1),
                   rhu.reshape(20, 20, -1), rhv.reshape(20, 20, -1), n))
    j = np.linspace(0, 1, 50).astype(np.float32)
    s = np.arange(50, dtype=np.int32)
    _close(TES.minhash_intersection(torch.from_numpy(j), torch.from_numpy(s),
                                    torch.from_numpy(s[::-1].copy())),
           RES.minhash_intersection(R(j), R(s), R(s[::-1].copy())))


def test_kmv_and_bloom_estimators_match_reference(sessions):
    """kmv_size, kmv_union_size, kmv_intersection (full and partly filled
    rows) and bf_false_positive_rate: rtol 1e-6."""
    rng = np.random.default_rng(12)
    rs, ts = sessions["kmv"]
    (ru, rv, du, dv), (tu, tv, tdu, tdv) = _pair_rows(rs, ts, rng)
    R = jnp.asarray
    _close(TES.kmv_size(tu), RES.kmv_size(R(ru)))
    _close(TES.kmv_union_size(tu, tv), RES.kmv_union_size(R(ru), R(rv)))
    _close(TES.kmv_intersection(tu, tv, tdu, tdv),
           RES.kmv_intersection(R(ru), R(rv), R(du), R(dv)))
    assert bool((ru == 2.0).any()) and bool((ru < 2.0).all(axis=1).any())
    rb, tb = sessions["bf"]
    (bu, _, _, _), (tbu, _, _, _) = _pair_rows(rb, tb, rng)
    for b in (1, 2, 3):
        _close(TES.bf_false_positive_rate(tbu, b),
               RES.bf_false_positive_rate(R(bu), b))


@pytest.mark.parametrize("name", ["bf", "kh", "1h", "1h-naive", "kmv"])
def test_pair_estimator_table_matches_reference(sessions, name):
    """pair_estimator(kind) gives the reference's estimates: rtol 1e-6."""
    kind, kw = CONFIGS[name]
    rs, ts = sessions[name]
    rng = np.random.default_rng(13)
    (ru, rv, du, dv), (tu, tv, tdu, tdv) = _pair_rows(rs, ts, rng)
    sk = rs.sketch
    rctx = {"num_hashes": sk.num_hashes, "n": sk.n,
            "hash_of": lambda x: RS.onehash_values(x, sk.n, sk.seed), **kw}
    tctx = {"num_hashes": sk.num_hashes, "n": sk.n,
            "hash_of": lambda x: TS.onehash_values(x, sk.n, sk.seed), **kw}
    _close(TES.pair_estimator(kind)(tu, tv, tdu, tdv, tctx),
           RES.pair_estimator(kind)(jnp.asarray(ru), jnp.asarray(rv),
                                    jnp.asarray(du), jnp.asarray(dv), rctx))


# ----------------------------------------------------------------------------
# sessions: per-edge estimates, TC, LCC, similarities
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("degree_order", [False, True])
@pytest.mark.parametrize("name", ["kh", "1h", "1h-naive", "kmv"])
def test_session_matches_reference(sessions, name, degree_order):
    """Per-edge cardinalities rtol 1e-6 (through chunks of 1000 edges, with
    and without the hub layout); TC rtol 1e-5; LCC rtol 1e-5, atol 1e-6."""
    rs, ts = sessions[name]
    assert np.array_equal(_np(ts.sketch.data), np.asarray(rs.sketch.data))
    assert dataclasses.asdict(ts.plan) == dataclasses.asdict(rs.plan)
    assert ts.stats() == rs.stats()
    kw = dict(degree_order=degree_order, edge_chunk=1000)
    r_plan, t_plan = rs.plan.with_(**kw), ts.plan.with_(**kw)
    ref = np.asarray(RE.edge_cardinalities(rs.graph, rs.sketch, r_plan))
    got = TE.edge_cardinalities(ts.graph, ts.sketch, t_plan)
    assert got.dtype == torch.float32
    _close(got, ref)
    _close(ts.edge_cardinalities(), rs.edge_cardinalities())
    np.testing.assert_allclose(float(ts.triangle_count()),
                               float(rs.triangle_count()), rtol=1e-5)
    _close(ts.local_clustering(), rs.local_clustering(), rtol=1e-5,
           atol=1e-6)


@pytest.mark.parametrize("name", ["bf", "kh", "1h", "1h-naive", "kmv"])
def test_similarities_match_reference(sessions, name):
    """edge_similarity and pair_similarity (edges and non-edges) for the
    four cardinality measures: rtol 1e-6 (MinHash/KMV: identical
    estimates), Bloom rtol 1e-5 (a ratio of ulp-close estimates)."""
    rs, ts = sessions[name]
    rtol = 1e-5 if name == "bf" else 1e-6
    rng = np.random.default_rng(14)
    pairs = rng.integers(0, rs.graph.n, size=(777, 2)).astype(np.int32)
    for measure in MEASURES:
        _close(ts.edge_similarity(measure), rs.edge_similarity(measure),
               rtol=rtol)
        _close(ts.similarity(torch.from_numpy(pairs), measure),
               rs.similarity(jnp.asarray(pairs), measure), rtol=rtol)
        _close(TSIM.pair_similarity(ts.graph, torch.from_numpy(pairs),
                                    measure, ts.sketch, edge_chunk=100),
               RSIM.pair_similarity(rs.graph, jnp.asarray(pairs), measure,
                                    rs.sketch, edge_chunk=100), rtol=rtol)
    inter = torch.from_numpy(rng.random(50).astype(np.float32) * 5)
    du = torch.from_numpy(rng.integers(0, 9, 50).astype(np.float32))
    dv = torch.from_numpy(rng.integers(0, 9, 50).astype(np.float32))
    for measure in MEASURES:
        _close(TSIM.similarity_from_cardinalities(inter, du, dv, measure),
               RSIM.similarity_from_cardinalities(
                   jnp.asarray(inter.numpy()), jnp.asarray(du.numpy()),
                   jnp.asarray(dv.numpy()), measure))


def test_unported_similarities_raise(graphs, sessions):
    """adamic_adar / resource_alloc on the Bloom session match the
    reference's (its float32 sums in another order: rtol 1e-6 plus their
    error bound, (d_u - 1)·2⁻²⁴); on a k-Hash session they raise
    ValueError, as in the reference; unknown measures raise ValueError."""
    rs, ts = sessions["bf"]
    rng = np.random.default_rng(3)
    pairs = np.concatenate([np.asarray(rs.graph.edges)[:200],
                            rng.integers(0, rs.graph.n, (100, 2))]
                           ).astype(np.int32)
    terms = ts.graph.deg[torch.from_numpy(pairs[:, 0]).long()].numpy()
    rtol = 1e-6 + np.maximum(terms - 1, 0) * 2.0 ** -24
    for measure in ("adamic_adar", "resource_alloc"):
        want = np.asarray(rs.similarity(jnp.asarray(pairs), measure))
        got = ts.similarity(torch.from_numpy(pairs), measure).numpy()
        assert (np.abs(got - want) <= rtol * np.abs(want)).all()
        with pytest.raises(ValueError, match="exact or BF"):
            sessions["kh"][1].similarity(torch.from_numpy(pairs), measure)
    pairs = torch.tensor([[0, 1]], dtype=torch.int32)
    with pytest.raises(ValueError):
        ts.similarity(pairs, "bogus")
    with pytest.raises(ValueError):
        ts.edge_similarity("bogus")


def test_prebuilt_sketch_sessions(graphs, sessions):
    """session() takes a prebuilt kh/1h/kmv SketchSet carried from the
    reference's arrays and gives the same per-edge estimates."""
    _, tg = graphs["kron"]
    for name in ("kh", "1h", "kmv"):
        rs, ts = sessions[name]
        sk = rs.sketch
        pre = convert.sketch_from_numpy(np.asarray(sk.data), sk.kind,
                                        sk.num_hashes, sk.k, sk.seed, sk.n,
                                        device=CPU)
        again = TE.session(tg, pre, device=CPU)
        assert torch.equal(again.edge_cardinalities(),
                           ts.edge_cardinalities())


# ----------------------------------------------------------------------------
# Jarvis–Patrick
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("density", [0.0, 0.05, 0.3, 1.0])
@pytest.mark.parametrize("graph", ["kron", "iso"])
def test_connected_components_bit_identical(graphs, graph, density):
    """Given the same kept-edge mask the labels equal the reference's,
    also when max_iters stops the propagation early."""
    rg, tg = graphs[graph]
    keep = np.random.default_rng(int(density * 100)).random(rg.m) < density
    for max_iters in (1, 2, 200):
        ref = np.asarray(RCL._connected_components(
            rg.n, rg.edges, jnp.asarray(keep), max_iters))
        got = TCL._connected_components(tg.n, tg.edges,
                                        torch.from_numpy(keep), max_iters)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name", ["bf", "kh", "1h", "1h-naive", "kmv"])
def test_jarvis_patrick_matches_reference(sessions, name):
    """End to end: the kept-edge masks differ only at edges whose score is
    within 1e-5 (relative) of the threshold; where the masks agree the
    labels and cluster counts are equal, and the port's components on the
    reference's mask give the reference's labels."""
    rs, ts = sessions[name]
    rg, tg = rs.graph, ts.graph
    for similarity, threshold in (("jaccard", 0.05), ("common", 2.0),
                                  ("overlap", 0.1)):
        r_labels, r_num = rs.jarvis_patrick(similarity, threshold)
        t_labels, t_num = ts.jarvis_patrick(similarity, threshold)
        r_score = np.asarray(rs.edge_similarity(similarity))
        t_score = ts.edge_similarity(similarity).numpy()
        r_keep, t_keep = r_score >= threshold, t_score >= threshold
        differ = r_keep != t_keep
        assert np.all(np.abs(r_score[differ] - threshold)
                      <= 1e-5 * max(1.0, threshold))
        if not differ.any():
            assert np.array_equal(t_labels.numpy(), np.asarray(r_labels))
            assert int(t_num) == int(r_num)
        same_mask = TCL._connected_components(tg.n, tg.edges,
                                              torch.from_numpy(r_keep))
        assert np.array_equal(same_mask.numpy(), np.asarray(r_labels))


def test_mine_session_jp_matches_reference(graphs):
    """launch/mine.py runs ``jp`` (Jaccard >= 0.05, cluster count) on its
    Bloom session as the reference's mine_session does."""
    rg, tg = graphs["kron"]
    ref = RM.mine_session(rg, ["tc", "jp"], storage_budget=0.25)
    got = TM.mine_session(tg, ["tc", "jp"], storage_budget=0.25, device=CPU)
    assert got["jp"][0] == ref["jp"][0]
    np.testing.assert_allclose(got["tc"][0], ref["tc"][0], rtol=1e-5)
