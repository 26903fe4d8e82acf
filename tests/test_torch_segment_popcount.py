"""Port parity, the segmented k-way AND popcount (the clique passes' form).

``fused_segment_popcount(data, heads, offsets, tails)`` is the k-way AND
popcount of the tuples ``(heads[s], tails[t])`` for ``offsets[s] <= t <
offsets[s+1]``. Its plain version (``kernels.ref``) and the engine's
``segment_cardinality_ones(use_kernel=False)`` must equal, bit for bit, the
JAX package's ``tuple_cardinality_ones`` (plain path,
``EnginePlan(use_kernel=False)``) on the expanded ``[T, k]`` tuples. Out-of-
range ids clamp, as the port's ``[T, k]`` plain version does (ROADMAP
Queue 3, difference 1). The Bloom clique counts through segments equal
the stacked ``[T, k]`` route bit for bit when the launches cut the same
tails, which they do: both cut each piece every ``_LAUNCH_TUPLES`` tuples.
The CUDA kernel itself is tested on the card
(``tests/test_torch_kernels_cuda.py``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import engine as RE
from repro.core import sketches as RS
from repro_torch import engine as TE
from repro_torch.convert import sketch_from_numpy
from repro_torch.core import estimators as est, graph as TG
from repro_torch.core.algorithms import cliques as TC
from repro_torch.kernels import fused_expr, program, ref

#: segment lengths mixed into every layout: empty, short, around a tile
#: (32 tails) and a warp's chunk (256 tails)
_LENGTHS = (0, 0, 0, 1, 2, 5, 31, 32, 33, 255, 256, 257)


def _segments(rng, n: int, k: int, lengths):
    """int32 heads[S, k-1], int64 offsets[S+1], int32 tails[T]."""
    heads = rng.integers(0, n, (len(lengths), k - 1)).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    tails = rng.integers(0, n, int(offsets[-1])).astype(np.int32)
    return heads, offsets, tails


def _expand(heads, offsets, tails):
    """The [T, k] tuples the segments stand for."""
    return np.concatenate([np.repeat(heads, np.diff(offsets), axis=0),
                           tails[:, None]], axis=1).astype(np.int32)


def _sketches(rng, n: int, w: int):
    """A random Bloom matrix as the reference's and the port's sketch."""
    data = rng.integers(0, 2 ** 32, (n, w), dtype=np.uint64).astype(
        np.uint32)
    data[0] = 0xFFFFFFFF                      # an all-ones row
    rs = RS.SketchSet(data=jnp.asarray(data), kind="bf", num_hashes=2, k=0,
                      seed=0, n=n)
    return rs, sketch_from_numpy(data, "bf", 2, 0, 0, n, device="cpu")


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("w", [1, 7, 30, 32, 33])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_segment_popcounts_identical_to_reference(k, w):
    """Mixed segment lengths, empty ones included, and a lone segment:
    the plain version and the engine's plain path equal the reference's
    popcounts of the expanded tuples."""
    rng = np.random.default_rng(100 * k + w)
    n = 4096
    rs, ts = _sketches(rng, n, w)
    lengths = rng.permutation(np.array(_LENGTHS * 3))
    for layout in (lengths, [700]):
        heads, offsets, tails = _segments(rng, n, k, layout)
        want = np.asarray(RE.tuple_cardinality_ones(
            rs, jnp.asarray(_expand(heads, offsets, tails)),
            RE.EnginePlan(use_kernel=False)))
        th, to, tt = _torch(heads, offsets, tails)
        got = ref.fused_segment_popcount(ts.data, th, to, tt)
        assert got.dtype == torch.int32 and got.shape == (tails.shape[0],)
        assert np.array_equal(got.numpy(), want)
        via_engine = TE.segment_cardinality_ones(
            ts, th, to.to(torch.int32), tt, TE.EnginePlan(use_kernel=False))
        assert torch.equal(via_engine, got)
        # the wrapper's CPU path is the plain version
        assert torch.equal(fused_expr.fused_segment_popcount(
            ts.data, th, to, tt), got)


def test_launch_cuts_inside_segments():
    """Tails cut into launches anywhere, inside segments and inside one
    segment longer than a launch, with offsets clamped to each launch,
    give the popcounts of the whole."""
    rng = np.random.default_rng(7)
    n, w = 1000, 32
    _, ts = _sketches(rng, n, w)
    heads, offsets, tails = _segments(rng, n, 3, [0, 3, 5000, 0, 40, 1, 0])
    th, to, tt = _torch(heads, offsets, tails)
    whole = ref.fused_segment_popcount(ts.data, th, to, tt)
    assert torch.equal(whole, ref.fused_gather_popcount(
        ts.data, torch.from_numpy(_expand(heads, offsets, tails)),
        program.and_program(3)))
    for cuts in ([0, 1000, 2000, 3000, 4000, 5000], [0, 2, 4, 5003, 5030],
                 [0, 5044]):
        parts = []
        for lo, hi in zip(cuts, cuts[1:] + [tails.shape[0]]):
            part = tt[lo:hi]
            parts.append(ref.fused_segment_popcount(
                ts.data, th, (to - lo).clamp(0, part.shape[0]), part))
        assert torch.equal(torch.cat(parts), whole)


def test_fold_segments_cuts_launches_like_the_stacked_fold(monkeypatch):
    """cliques._fold_segments with launches of 1000 tails (one segment of
    3000) sums the same per-tuple estimates, in the same launches, as the
    stacked [T, k] fold; closed_segments gives the stacked pieces' tuples
    in their order."""
    rng = np.random.default_rng(8)
    _, ts = _sketches(rng, 600, 30)
    heads, offsets, tails = _segments(rng, 600, 4, [3000, 0, 17, 999, 2])
    th, to, tt = _torch(heads, offsets, tails)
    monkeypatch.setattr(TC, "_LAUNCH_TUPLES", 1000)
    plan = TE.EnginePlan(use_kernel=False)
    zero = torch.zeros((), dtype=torch.float64)
    got = TC._fold_segments(ts, plan, [(th, to, tt)], zero)

    def values(t):
        return est.bf_intersection_and_from_ones(
            TE.tuple_cardinality_ones(ts, t.to(torch.int32), plan),
            ts.total_bits, ts.num_hashes)
    want = TC._fold(torch.from_numpy(_expand(heads, offsets, tails)),
                    values, zero)
    assert got.dtype == torch.float64 and torch.equal(got, want)
    monkeypatch.setattr(TC, "_CHUNK_CANDIDATES", 1 << 12)
    g = TG.kronecker(8, 16, seed=1, device="cpu")
    sketch = TE.session(g, "bf", storage_budget=0.5, device="cpu").sketch
    for k, stacked in ((3, TC.closed_triangles), (4, TC.closed_quads)):
        pieces = [_expand(*(x.numpy() for x in seg))
                  for seg in TC.closed_segments(g, sketch, k)]
        assert len(pieces) > 1
        assert np.array_equal(np.concatenate(pieces), torch.cat(
            list(stacked(g, sketch))).numpy())


def test_out_of_range_ids_clamp_like_gather_plain():
    """Ids outside [0, n), in heads and tails, read the nearest row, as the
    port's [T, k] plain version does."""
    rng = np.random.default_rng(9)
    n = 50
    _, ts = _sketches(rng, n, 33)
    heads, offsets, tails = _segments(rng, n, 4, [3, 0, 40, 1])
    heads[0, 1], heads[2, 0] = -5, n + 9
    tails[::4], tails[1::9] = n, -1
    th, to, tt = _torch(heads, offsets, tails)
    want = ref.fused_gather_popcount(
        ts.data, torch.from_numpy(_expand(heads, offsets, tails)),
        program.and_program(4))
    assert torch.equal(ref.fused_segment_popcount(ts.data, th, to, tt),
                       want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """Types, shapes, k outside 2..4 and tails without segments raise
    before any launch; T = 0 gives an empty result."""
    data = torch.zeros((6, 4), dtype=torch.int32)
    heads = torch.zeros((2, 2), dtype=torch.int32)
    offsets = torch.tensor([0, 1, 3])
    tails = torch.zeros(3, dtype=torch.int32)
    bad = [
        (data, torch.zeros((2, 3, 1), dtype=torch.int32), offsets, tails,
         "heads"),
        (data, torch.zeros((2, 4), dtype=torch.int32), offsets, tails,
         "heads"),                                           # k = 5
        (data, torch.zeros((2, 0), dtype=torch.int32), offsets, tails,
         "heads"),                                           # k = 1
        (data, heads.long(), offsets, tails, "heads"),
        (data, heads, offsets.float(), tails, "offsets"),
        (data, heads, offsets[:2], tails, "offsets"),
        (data, heads, offsets, tails.long(), "tails"),
        (data, heads, offsets, tails[:, None], "tails"),
        (data.long(), heads, offsets, tails, "data"),
        (data, heads[:0], offsets[:1], tails, "S = 0"),
        (data, heads, offsets, tails.to("meta"), "devices"),
    ]
    for d, h, o, t, match in bad:
        with pytest.raises(ValueError, match=match):
            fused_expr.fused_segment_popcount(d, h, o, t)
    empty = fused_expr.fused_segment_popcount(
        data, heads[:0], offsets[:1], tails[:0])
    assert empty.shape == (0,) and empty.dtype == torch.int32
    g = TG.kronecker(6, 4, seed=1, device="cpu")
    kh = TE.session(g, "kh", device="cpu").sketch
    with pytest.raises(ValueError, match="Bloom"):
        TE.segment_cardinality_ones(kh, heads, offsets, tails,
                                    TE.EnginePlan(use_kernel=False))
    bf = TE.session(g, "bf", device="cpu").sketch
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA"):
        TE.segment_cardinality_ones(bf, heads, offsets, tails,
                                    TE.EnginePlan(use_kernel=True))


def _stacked(pieces, sketch, plan, divisor: float) -> torch.Tensor:
    """The Bloom clique estimate over stacked [T, k] pieces, in launches
    of ``_LAUNCH_TUPLES`` tuples per piece (the route before segments)."""
    total = torch.zeros((), dtype=torch.float64)
    for t in pieces:
        for s in range(0, t.shape[0], TC._LAUNCH_TUPLES):
            ones = TE.tuple_cardinality_ones(
                sketch, t[s:s + TC._LAUNCH_TUPLES].to(torch.int32), plan)
            total = total + torch.sum(est.bf_intersection_and_from_ones(
                ones, sketch.total_bits, sketch.num_hashes),
                dtype=torch.float64)
    return (total / divisor).to(torch.float32)


@pytest.mark.parametrize("scale", [8, 9])
@pytest.mark.parametrize("small", [False, True])
def test_bloom_cliques_segmented_equal_stacked(scale, small, monkeypatch):
    """four_clique_count / five_clique_count (Bloom, plain path) through
    segments equal the stacked route bit for bit: the same per-tuple
    values, cut into the same launches. ``small`` cuts pieces and launches
    into a few thousand tuples, so launches split segments."""
    if small:
        monkeypatch.setattr(TC, "_CHUNK_CANDIDATES", 1 << 13)
        monkeypatch.setattr(TC, "_LAUNCH_TUPLES", 1000)
    g = TG.kronecker(scale, 16, seed=1, device="cpu")
    sess = TE.session(g, "bf", storage_budget=0.5, device="cpu")
    plan = sess.plan
    assert not plan.use_kernel
    got4 = TC.four_clique_count(g, sess.sketch, plan)
    want4 = _stacked(TC.closed_triangles(g, sess.sketch), sess.sketch, plan,
                     4.0)
    got5 = TC.five_clique_count(g, sess.sketch, plan)
    want5 = _stacked(TC.closed_quads(g, sess.sketch), sess.sketch, plan, 5.0)
    assert float(want4) > 0 and float(want5) > 0
    assert torch.equal(got4, want4) and torch.equal(got5, want5)
