"""Port parity, set-expression layer: program compiler, plain kernels, ops.

The port's plain ``fused_gather_popcount`` / ``fused_rows_popcount`` (the
CPU path of the CUDA kernels' wrappers) and ``CompiledSetExpr`` are held
to the reference's ``CompiledSetExpr(..., use_kernel=False)``, its
``kernels/ref.py`` oracles and its dense Pallas kernel in interpret mode.
Popcounts are integers and must be identical. The reference's gather
Pallas kernel is not called: it no longer runs on the installed jax (it
reads ``pltpu.TPUMemorySpace``, which was removed).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.engine import setexpr as RX
from repro.kernels import fused_expr as RF
from repro.kernels import ref as RR
from repro_torch.engine import setexpr as TX
from repro_torch.kernels import fused_expr as TF
from repro_torch.kernels import ops as TO
from repro_torch.kernels import program as TP
from repro_torch.kernels import ref as TR


def _exprs(mod):
    r = mod.rows(8)
    u, v, w, x = r[:4]
    return {
        "and2": u & v,
        "and3": u & v & w,
        "and4": u & v & w & x,
        "or": u | v,
        "andnot": (u & v) - w,
        "nested": (u | (v & w)) - (x | u),
        "sparse_slots": mod.Row(1) & mod.Row(3),
        # 8 leaves, 15 instructions: the kernels' interpreted path at its
        # widest
        "leaves8": ((r[0] & r[1]) | (r[2] & r[3]))
        - ((r[4] | r[5]) & (r[6] | r[7])),
    }


NAMES = list(_exprs(TX))


def _words(rng, shape) -> np.ndarray:
    """Random uint32 words, top bit included."""
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        a.view(np.int32) if a.dtype == np.uint32 else a))


#: (t, w): ragged T with W below and above a warp, then T at the edges of
#: the kernels' tiles (16 and 32 tuples) with odd and wide W (4-byte
#: loads, column blocks)
_GATHER_SHAPES = [(t, w) for w in (2, 8, 34) for t in (1, 37, 257)] + [
    (31, 3), (32, 31), (33, 129), (65, 31), (16, 3), (17, 129)]


@pytest.mark.parametrize("t,w", _GATHER_SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_gather_form_identical_to_reference(name, w, t):
    """Plain fused_gather_popcount and CompiledSetExpr.ones equal the
    reference's CompiledSetExpr(use_kernel=False).ones (ragged T, tile
    edges, odd and wide W, up to 8 leaves)."""
    rng = np.random.default_rng(NAMES.index(name) * 10000 + w * 1000 + t)
    bloom = _words(rng, (50, w))
    tuples = rng.integers(0, 50, size=(t, 8)).astype(np.int32)
    ref = np.asarray(RX.compile_expr(_exprs(RX)[name], use_kernel=False)
                     .ones(jnp.asarray(bloom), jnp.asarray(tuples)))
    ce = TX.compile_expr(_exprs(TX)[name], use_kernel=False)
    got = ce.ones(_t(bloom), _t(tuples))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    direct = TF.fused_gather_popcount(_t(bloom), _t(tuples), ce.program)
    assert np.array_equal(direct.numpy(), ref)


@pytest.mark.parametrize("w", [2, 8, 34])
def test_and_entry_points_identical_to_reference_oracles(w):
    """bf_edge_intersect(3) and the dense AND pairs equal kernels/ref.py."""
    rng = np.random.default_rng(w)
    bloom = _words(rng, (40, w))
    edges = rng.integers(0, 40, size=(101, 2)).astype(np.int32)
    triples = rng.integers(0, 40, size=(101, 3)).astype(np.int32)
    ref2 = np.asarray(RR.bf_edge_intersect(jnp.asarray(bloom),
                                           jnp.asarray(edges)))
    ref3 = np.asarray(RR.bf_edge_intersect3(jnp.asarray(bloom),
                                            jnp.asarray(triples)))
    for got in (TO.bf_edge_intersect(_t(bloom), _t(edges)),
                TR.bf_edge_intersect(_t(bloom), _t(edges))):
        assert np.array_equal(got.numpy(), ref2)
    for got in (TO.bf_edge_intersect3(_t(bloom), _t(triples)),
                TR.bf_edge_intersect3(_t(bloom), _t(triples))):
        assert np.array_equal(got.numpy(), ref3)
    a, b, c = (_words(rng, (29, w)) for _ in range(3))
    assert np.array_equal(
        TO.bf_intersect_pairs(_t(a), _t(b)).numpy(),
        np.asarray(RR.bf_intersect_pairs(jnp.asarray(a), jnp.asarray(b))))
    assert np.array_equal(
        TO.bf_intersect3_pairs(_t(a), _t(b), _t(c)).numpy(),
        np.asarray(RR.bf_intersect3_pairs(jnp.asarray(a), jnp.asarray(b),
                                          jnp.asarray(c))))
    assert np.array_equal(
        TR.bf_union_pairs(_t(a), _t(b)).numpy(),
        np.asarray(RR.bf_union_pairs(jnp.asarray(a), jnp.asarray(b))))


#: (w, e): E = 24 in blocks of 8 rows, then E at the edges of the kernels'
#: tiles, one block each, with odd and wide W
_ROWS_SHAPES = [pytest.param(w, 24, id=str(w)) for w in (2, 8, 34)] + [
    pytest.param(w, e, id=f"{w}-{e}")
    for w, e in ((3, 31), (31, 32), (129, 33), (31, 65))]


@pytest.mark.parametrize("w,e", _ROWS_SHAPES)
@pytest.mark.parametrize("name", ["and2", "and3", "or", "nested", "leaves8"])
def test_rows_form_identical_to_reference_interpret(name, w, e):
    """Plain fused_rows_popcount and ones_rows equal the reference's dense
    Pallas kernel run in interpret mode."""
    rng = np.random.default_rng(w * 7 + len(name) + e)
    ce = TX.compile_expr(_exprs(TX)[name], use_kernel=False)
    operands = [_words(rng, (e, w)) for _ in ce.slots]
    rexpr = _exprs(RX)[name]
    slots = RX.expr_slots(rexpr)
    eval_fn = RX._make_eval(rexpr, {s: i for i, s in enumerate(slots)})
    ref = np.asarray(RF.fused_rows_popcount(
        [jnp.asarray(o) for o in operands], eval_fn,
        block_e=8 if e % 8 == 0 else e, block_w=w, interpret=True))
    got = TF.fused_rows_popcount([_t(o) for o in operands], ce.program)
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(ce.ones_rows(*[_t(o) for o in operands]).numpy(),
                          ref)


@pytest.mark.parametrize("w", [2, 8, 34])
def test_dense_and_identical_to_reference_bf_intersect_kernels(w):
    """ops.bf_intersect_pairs / bf_intersect3_pairs (the AND2/AND3 forms of
    the dense kernel) equal the reference's own dense Pallas kernels
    ``bf_intersect._pairs_impl`` / ``_pairs3_impl``, run in interpret mode
    through their deprecated shims (E and W block-aligned, as they need)."""
    from repro.kernels import bf_intersect as RB

    rng = np.random.default_rng(100 + w)
    a, b, c = (_words(rng, (24, w)) for _ in range(3))
    with pytest.warns(DeprecationWarning):
        ref2 = np.asarray(RB.bf_intersect_pairs(
            jnp.asarray(a), jnp.asarray(b), block_e=8, block_w=w,
            interpret=True))
    with pytest.warns(DeprecationWarning):
        ref3 = np.asarray(RB.bf_intersect3_pairs(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), block_e=8,
            block_w=w, interpret=True))
    assert np.array_equal(TO.bf_intersect_pairs(_t(a), _t(b)).numpy(), ref2)
    assert np.array_equal(
        TO.bf_intersect3_pairs(_t(a), _t(b), _t(c)).numpy(), ref3)
    assert np.array_equal(TR.bf_intersect3_pairs(_t(a), _t(b), _t(c)).numpy(),
                          ref3)


def test_program_compiler_shapes_and_limits():
    """Postfix programs, the AND fast-path tag, and the 16/8 limits."""
    u, v, w = TX.rows(3)
    p = TX.compile_program(u & v)
    assert (p.ops, p.args, p.slots, p.and_k) == (
        (TP.PUSH, TP.PUSH, TP.AND), (0, 1, 0), (0, 1), 2)
    assert TX.compile_program(TX.and_all(*TX.rows(4))).and_k == 4
    assert TX.compile_program(TX.Row(2) & TX.Row(5)).slots == (2, 5)
    assert TX.compile_program((u & v) - w).and_k == 0
    assert TX.compile_program(u | v).and_k == 0
    assert TX.compile_program(u).and_k == 0
    assert TX.compile_program(TX.and_all(*TX.rows(8))).n_leaves == 8
    with pytest.raises(ValueError, match="distinct leaves"):
        TX.compile_program(TX.and_all(*TX.rows(9)))
    big = TX.or_all(*[a & b for a, b in [(u, v), (v, w), (u, w), (v, u),
                                         (w, u)]])
    with pytest.raises(ValueError, match="19 instructions"):
        TX.compile_program(big)
    with pytest.raises(ValueError):
        TP.Program(ops=(TP.PUSH, TP.AND), args=(0, 0), slots=(0,))
    with pytest.raises(ValueError):
        TP.Program(ops=(TP.PUSH, TP.PUSH), args=(0, 0), slots=(0,))
    with pytest.raises(ValueError):
        TP.Program(ops=(TP.PUSH,), args=(1,), slots=(0,))
    packed = list(p.packed())
    assert len(packed) == TP.PACKED_INTS
    assert packed[:3] == [3, 2, 2]


def test_program_evaluator_matches_numpy():
    """eval_program on int32 bit patterns equals numpy uint32 bit algebra."""
    rng = np.random.default_rng(1)
    a, b, c, d = (_words(rng, (5, 3)) for _ in range(4))
    u, v, w, x = TX.rows(4)
    p = TX.compile_program((u | (v & w)) - (x | u))
    got = TP.eval_program(p, [_t(a), _t(b), _t(c), _t(d)])
    want = (a | (b & c)) & ~(d | a)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_compiled_expr_checks_and_cache():
    """Width and arity checks, empty inputs, and the structure-keyed cache."""
    TX.cache_clear()
    u, v, w = TX.rows(3)
    ce = TX.compile_expr(u & w, use_kernel=False)
    assert TX.compile_expr(TX.Row(0) & TX.Row(2), use_kernel=False) is ce
    assert TX.cache_info() == {"size": 1, "hits": 1}
    assert TX.compile_expr(u & w, use_kernel=True) is not ce
    data = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="column 2"):
        ce.ones(data, torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="distinct leaves"):
        ce.ones_rows(data)
    assert ce.ones(data, torch.zeros((0, 3), dtype=torch.int32)).shape == (0,)
    assert ce.ones_rows(data[:0], data[:0]).shape == (0,)
    TX.cache_clear()
    assert TX.cache_info() == {"size": 0, "hits": 0}


def test_out_of_range_ids_differ_from_reference():
    """Ids outside [0, n) read the nearest row in the port (kernel and
    plain version alike); the reference wraps ids in [-n, 0) and fills
    rows beyond with all-ones words. Valid ids agree."""
    bloom = np.array([[1], [3], [7]], dtype=np.uint32)
    tuples = np.array([[-1, 2], [0, 9], [1, 1]], dtype=np.int32)
    ref = np.asarray(RX.compile_expr(RX.and_all(*RX.rows(2)),
                                     use_kernel=False)
                     .ones(jnp.asarray(bloom), jnp.asarray(tuples)))
    got = TF.fused_gather_popcount(_t(bloom), _t(tuples), TP.and_program(2))
    assert ref.tolist() == [3, 1, 2]      # 7 & 7, 1 & 0xFFFFFFFF, 3 & 3
    assert got.tolist() == [1, 1, 2]      # 1 & 7, 1 & 7, 3 & 3


def test_cardinality_matches_reference():
    """CompiledSetExpr.cardinality: same ones, Swamidass map (rtol=1e-6)."""
    from repro.core import sketches as RS
    from repro_torch import convert

    rng = np.random.default_rng(4)
    bloom = _words(rng, (30, 6))
    tuples = rng.integers(0, 30, size=(70, 3)).astype(np.int32)
    rs = RS.SketchSet(data=jnp.asarray(bloom), kind="bf", num_hashes=2, k=0,
                      seed=0, n=30)
    ts = convert.sketch_from_numpy(bloom, "bf", 2, 0, 0, 30, device="cpu")
    expr_r = RX.and_all(*RX.rows(3))
    expr_t = TX.and_all(*TX.rows(3))
    ref = np.asarray(RX.compile_expr(expr_r, use_kernel=False)
                     .cardinality(rs, jnp.asarray(tuples)))
    got = TX.compile_expr(expr_t, use_kernel=False).cardinality(ts, _t(tuples))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
