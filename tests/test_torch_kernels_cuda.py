"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA GPU and nvcc and skip without them (the check is
made inside the ``cuda`` fixture, never at import). This file imports
neither jax nor the reference package, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_kernels_cuda.py

Popcounts are integers: kernel and plain version must be equal. The
float32 attention kernel computes in float32 like its plain version but
sums in another order: it agrees within atol = rtol = 2e-5 (the
reference's own kernel tolerance). The bfloat16 kernel rounds the
unnormalised P to bf16 before P·V on the tensor cores (l is summed from
the fp32 P), which moves an output by at most 2^-9·max|v|: it agrees
within atol = 1e-3 + 2^-8·max|v| (twice that bound, for the accumulation
order and where the scale is applied, on top of one bf16 rounding of the
output), rtol 1e-2, and a mean error of at most 1e-3.

The attention's gradient (``FlashAttentionFn``: the kernel forward, the
plain recompute backward) is held against autograd through the plain
version on the same tensors, and a reduced float32 train step on the
card against the same step on the CPU; the bounds are in the tests'
docstrings.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import pytest
import torch

from repro_torch import engine as TE
from repro_torch.core import graph as TG
from repro_torch.engine import setexpr
from repro_torch.core.algorithms import cliques
from repro_torch.kernels import (flash_attention, fused_expr, mh_intersect,
                                 ops, program, ref)
from repro_torch.obs.metrics import REGISTRY

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The CUDA device; skips the test when there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _programs():
    """Every program the kernels take a path for: the k-way ANDs (the
    template; the last reads permuted columns) and interpreted programs of
    up to 8 leaves, over tuples of 8 columns."""
    r = setexpr.rows(8)
    u, v, w, x = r[:4]
    chain = program.and_program(3)
    return [setexpr.compile_program(e) for e in
            (u & v, u & v & w, u & v & w & x, u | v, (u & v) - w,
             (u | (v & w)) - (x | u), setexpr.Row(3) & setexpr.Row(1),
             setexpr.and_all(*r),
             ((r[0] & r[1]) | (r[2] & r[3])) - ((r[4] | r[5]) & (r[6] | r[7])))
            ] + [program.Program(ops=chain.ops, args=chain.args,
                                 slots=(4, 0, 2))]


def _shifted(x):
    """A copy of contiguous ``x`` whose base lies one word past an
    allocation's start (4-byte but not 8- or 16-byte aligned)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("w", [1, 2, 3, 4, 8, 30, 31, 32, 33, 34, 128, 129,
                               600])
@pytest.mark.parametrize("t", [1, 15, 16, 17, 31, 32, 33, 65, 4099])
def test_kernels_equal_plain_versions(cuda, w, t):
    """Both forms, every program, T at the edges of 16- and 32-tuple
    tiles, W at every vector width (16-, 8- and 4-byte loads) and in
    column blocks (W > 128), operands aligned and one word past an
    allocation's start (the vector width falls back), ids outside [0, n)
    clamped, and two-column tuples (one 8-byte id load per tuple, aligned
    or not)."""
    gen = torch.Generator(device=cuda).manual_seed(w * 10007 + t)
    data = torch.randint(-2**31, 2**31 - 1, (997, w), dtype=torch.int32,
                         device=cuda, generator=gen)
    data[5] = -1
    tuples = torch.randint(-3, 1000, (t, 8), dtype=torch.int32, device=cuda,
                           generator=gen)
    for d in (data, _shifted(data)):
        for prog in _programs():
            before = dict(fused_expr.LAUNCHES)
            got = fused_expr.fused_gather_popcount(d, tuples, prog)
            rows = [ref.gather_rows(d, tuples[:, s]) for s in prog.slots]
            if d is not data:
                rows[0] = _shifted(rows[0])
            got_r = fused_expr.fused_rows_popcount(rows, prog)
            assert torch.equal(got, ref.fused_gather_popcount(d, tuples,
                                                              prog))
            assert torch.equal(got_r, ref.fused_rows_popcount(rows, prog))
            assert torch.equal(got, got_r)
            assert fused_expr.LAUNCHES["fused_gather_popcount"] == \
                before["fused_gather_popcount"] + 1
            assert fused_expr.LAUNCHES["fused_rows_popcount"] == \
                before["fused_rows_popcount"] + 1
        pairs = tuples[:, :2].contiguous()
        for tp in (pairs, _shifted(pairs), tuples[:, [6, 2]].contiguous()):
            p = program.and_program(2)
            assert torch.equal(fused_expr.fused_gather_popcount(d, tp, p),
                               ref.fused_gather_popcount(d, tp, p))


@pytest.mark.parametrize("w", [3, 32, 129])
def test_kernels_read_permuted_columns(cuda, w):
    """Tuples of 5 columns whose leaves read permuted slots (a leaf read
    twice, columns skipped) equal the plain version in both forms."""
    gen = torch.Generator(device=cuda).manual_seed(w)
    data = torch.randint(-2**31, 2**31 - 1, (500, w), dtype=torch.int32,
                         device=cuda, generator=gen)
    tuples = torch.randint(-2, 502, (1000, 5), dtype=torch.int32, device=cuda,
                           generator=gen)
    R = setexpr.Row
    chain = program.and_program(4)
    for prog in [setexpr.compile_program(e) for e in (
            (R(4) | R(1)) - R(3), R(2) & (R(0) | R(4)) & R(3),
            (R(4) - R(1)) | (R(0) & R(4)))] + [
            program.Program(ops=chain.ops, args=chain.args,
                            slots=(3, 4, 0, 2)),
            program.Program(ops=(program.PUSH, program.PUSH, program.AND),
                            args=(0, 1, 0), slots=(4, 1))]:
        want = ref.fused_gather_popcount(data, tuples, prog)
        assert torch.equal(fused_expr.fused_gather_popcount(data, tuples,
                                                            prog), want)
        rows = [ref.gather_rows(data, tuples[:, s]) for s in prog.slots]
        assert torch.equal(fused_expr.fused_rows_popcount(rows, prog), want)


def test_tile_layout(cuda):
    """The [T, k] kernels' layout: 16-byte loads by groups of 8 lanes at
    W = 32 (four rows a step); 8-byte loads by 16 lanes at W = 30 (15
    vectors); 4-byte loads at W = 33 (33 vectors: one row a step, in two
    column blocks), and at W = 32 when the base is not 16-byte aligned."""
    flat = torch.zeros(1 + 64 * 33, dtype=torch.int32, device=cuda)
    layout = {w: fused_expr.tile_layout(flat[:64 * w].view(64, w))
              for w in (32, 30, 33)}
    assert {w: (l["vector_words"], l["lanes_per_row"], l["rows_per_step"],
                l["column_blocks"]) for w, l in layout.items()} == {
        32: (4, 8, 4, 1), 30: (2, 16, 2, 1), 33: (1, 32, 1, 2)}
    assert (layout[32]["tuples_per_warp"], layout[32]["steps_per_batch"]) \
        == (16, 2)
    assert fused_expr.tile_layout(flat[1:1 + 64 * 32].view(64, 32))[
        "vector_words"] == 1


def test_out_of_range_ids_clamp_like_plain(cuda):
    """Ids outside [0, n) read the nearest row in both versions."""
    data = torch.tensor([[1], [3], [7]], dtype=torch.int32, device=cuda)
    tuples = torch.tensor([[-5, 0], [9, 2], [1, 1]], dtype=torch.int32,
                          device=cuda)
    p = program.and_program(2)
    assert fused_expr.fused_gather_popcount(data, tuples, p).tolist() == \
        [1, 3, 2]


def test_session_kernel_path_equals_plain_path(cuda):
    """A CUDA session uses the kernels (its per-edge pass is one launch of
    the gather AND2 with Eq. 2 in its store); its per-edge popcounts equal
    the plain path's and TC agrees within rtol 1e-5 (float sums)."""
    g = TG.kronecker(12, 16, seed=1, device=cuda)
    sess = TE.session(g, "bf", storage_budget=0.25, device=cuda)
    assert sess.plan.use_kernel and sess.plan.degree_order
    fused_expr.reset_launch_counts()
    tc = float(sess.triangle_count())
    assert fused_expr.LAUNCHES["fused_gather_popcount"] == 1
    assert fused_expr.FORM_LAUNCHES == {"gather/and2/card": 1}
    plain = sess.plan.with_(use_kernel=False)
    assert torch.equal(TE.tuple_cardinality_ones(sess.sketch, g.edges,
                                                 sess.plan),
                       TE.tuple_cardinality_ones(sess.sketch, g.edges, plain))
    tc_plain = float(TE.MiningSession(g, sess.sketch, plain).triangle_count())
    assert tc == pytest.approx(tc_plain, rel=1e-5)


def _chunked_edge_pass(g, sketch, plan, edges):
    """The per-edge pass as chunks of the gather AND2 and PyTorch's Eq. 2
    (``map_edges`` over the hub-ordered edges, unsorted after)."""
    fn = TE.pair_cardinality_fn(g, sketch, plan)
    if plan.degree_order and edges.shape[0] > 1:
        edges_s, inv = TE.order_edges_by_hub(g, edges)
        return TE.map_edges(edges_s, fn, plan)[inv]
    return TE.map_edges(edges, fn, plan)


def _fused_pass(g, sketch, plan, edges):
    """``edge_cardinalities`` of ``edges`` with the launches it made by
    form (counts zeroed before)."""
    fused_expr.reset_launch_counts()
    got = TE.edge_cardinalities(g, sketch, plan, edges=edges)
    return got, dict(fused_expr.FORM_LAUNCHES)


@pytest.mark.parametrize("degree_order", [False, True])
@pytest.mark.parametrize("words, b", [(32, 2), (30, 3)])
def test_fused_edge_pass_bit_identical_to_chunked(cuda, words, b,
                                                  degree_order):
    """The one-launch Bloom per-edge pass equals the chunked pass
    (edge_chunk 1,000: chunks of the gather AND2, then PyTorch's Eq. 2 ops)
    bit for bit, over every edge, a ragged prefix, pairs that name row
    n - 1, an empty list and a random edge subset as ``refresh`` passes it;
    at W = 30, b = 3 neither B / b nor 1 / B is a power of two. Each pass
    is one ``gather/and2/card`` launch and no ``gather/and2``."""
    from repro_torch.core import sketches as TS

    g = TG.kronecker(11, 16, seed=1, device=cuda)
    sk = TS.build(g, "bf", words=words, num_hashes=b, seed=7)
    plan = TE.plan_for(g, sk, degree_order=degree_order)
    assert plan.use_kernel and TE.fuses_edge_pass(sk, plan, g.edges.device)
    last = torch.tensor([[g.n - 1, 0], [3, g.n - 1], [g.n - 1, g.n - 1]],
                        dtype=torch.int32, device=cuda)
    gen = torch.Generator(device="cpu").manual_seed(5)
    subset = torch.randperm(g.m, generator=gen)[:g.m // 3].sort().values
    cases = {"all": g.edges, "ragged": g.edges[:12_345],
             "row n - 1": torch.cat([g.edges[:1_001], last]),
             "empty": g.edges[:0], "subset": g.edges[subset.to(cuda)]}
    for label, edges in cases.items():
        got, forms = _fused_pass(g, sk, plan, edges)
        want = _chunked_edge_pass(g, sk, plan.with_(edge_chunk=1000), edges)
        assert got.shape == (edges.shape[0],) and got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            (label, int((got != want).sum()))
        assert forms == ({"gather/and2/card": 1} if edges.shape[0] else {}), \
            (label, forms)


@pytest.mark.parametrize("degree_order", [False, True])
def test_fused_edge_pass_through_refresh(cuda, degree_order):
    """``MiningSession.refresh`` recomputes its invalidated edges with the
    fused pass (one launch), and the refreshed cardinalities equal a full
    chunked pass bit for bit."""
    import numpy as np

    g = TG.kronecker(11, 16, seed=1, device=cuda)
    sess = TE.session(g, "bf", storage_budget=1.0, device=cuda,
                      degree_order=degree_order)
    full = _chunked_edge_pass(g, sess.sketch, sess.plan.with_(edge_chunk=1000),
                              g.edges)
    sess.edge_cardinalities()
    carry = np.arange(g.m)
    carry[np.random.default_rng(1).choice(g.m, 4_097, replace=False)] = -1
    fused_expr.reset_launch_counts()
    assert sess.refresh(g, carry_index=carry) == 4_097
    assert fused_expr.FORM_LAUNCHES == {"gather/and2/card": 1}
    assert torch.equal(sess.edge_cardinalities().view(torch.int32),
                       full.view(torch.int32))


@pytest.mark.parametrize("words, b", [(1, 1), (30, 3), (32, 2), (33, 4),
                                      (64, 3)])
def test_fused_cardinality_every_count(cuda, words, b):
    """Every popcount 0..B of a row of W words, through the fused store,
    in pair order and visited in reverse: bit-identical to PyTorch's
    ``bf_intersection_and_from_ones`` of the gather kernel's counts on the
    card."""
    from repro_torch.core import estimators as est

    bits = 32 * words
    c = torch.arange(bits + 1, device=cuda)
    # row 0 all ones, row c + 1 with its lowest c bits set
    bit = torch.arange(bits, device=cuda)
    on = (bit[None, :] < c[:, None]).to(torch.int64).view(bits + 1, words, 32)
    rows = (on << torch.arange(32, device=cuda)).sum(-1)
    rows = torch.cat([torch.full((1, words), -1, device=cuda),
                      torch.where(rows >= 1 << 31, rows - (1 << 32), rows)])
    data = rows.to(torch.int32).contiguous()
    pairs = torch.stack([torch.zeros_like(c), c + 1], 1).to(torch.int32)
    ones = fused_expr.fused_gather_popcount(data, pairs,
                                            program.and_program(2))
    assert torch.equal(ones, c.to(torch.int32))
    want = est.bf_intersection_and_from_ones(ones, bits, b)
    for order in (None, torch.arange(bits, -1, -1, device=cuda)):
        got = fused_expr.fused_gather_cardinality(data, pairs, b, order=order)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            (int((got != want).sum()), got[got != want][:4].tolist(),
             want[got != want][:4].tolist())


def test_fused_cardinality_rejects_bad_operands(cuda):
    """Wrong dtypes, shapes or devices raise before any launch."""
    data = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    pairs = torch.zeros((3, 2), dtype=torch.int32, device=cuda)
    for bad in (dict(pairs=pairs.long()), dict(pairs=pairs[:, :1]),
                dict(pairs=pairs.cpu()),
                dict(order=torch.arange(3, device=cuda, dtype=torch.int32)),
                dict(order=torch.arange(4, device=cuda)),
                dict(order=torch.arange(3))):
        kw = {"pairs": pairs, "order": None, **bad}
        with pytest.raises(ValueError):
            fused_expr.fused_gather_cardinality(data, kw["pairs"], 2,
                                                order=kw["order"])


def test_kernel_rejects_cpu_operand_mix(cuda):
    """Mixed devices raise instead of copying or falling back."""
    p = program.and_program(2)
    data = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        fused_expr.fused_gather_popcount(
            data, torch.zeros((3, 2), dtype=torch.int32), p)
    with pytest.raises(ValueError):
        fused_expr.fused_rows_popcount([data, data.cpu()], p)


def _segments(gen, device, n: int, k: int, lengths, offset_dtype):
    """int32 heads[S, k-1], offsets[S+1] and int32 tails[T] on the card;
    ids drawn from [-3, n + 3), so some clamp."""
    lengths = torch.tensor(lengths, dtype=torch.int64)
    heads = torch.randint(-3, n + 3, (lengths.numel(), k - 1),
                          dtype=torch.int32, device=device, generator=gen)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                         torch.cumsum(lengths, 0)]).to(device, offset_dtype)
    tails = torch.randint(-3, n + 3, (int(lengths.sum()),),
                          dtype=torch.int32, device=device, generator=gen)
    return heads, offsets, tails


def _expanded(heads, offsets, tails):
    counts = (offsets[1:] - offsets[:-1]).long()
    return torch.cat([heads.repeat_interleave(counts, 0), tails[:, None]],
                     dim=1)


#: segment lengths around a tile (32), a warp's chunk (256) and far beyond
_SEGMENT_LENGTHS = [0, 1, 255, 256, 257, 0, 0, 31, 32, 33, 100_000, 3, 0, 1]


@pytest.mark.parametrize("w", [1, 7, 30, 32, 33, 64, 600, 2000, 4000])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_segment_kernel_equals_plain_and_gather_kernel(cuda, k, w):
    """The segmented kernel equals its plain version and the [T, k] gather
    kernel on the expanded tuples: segments of 0 to 10^5 tails, runs of
    empty segments, ids to clamp, int32 and int64 offsets. W = 30 leaves
    odd rows 8-byte aligned; W = 600 gets 4 cache slots per warp, W = 2000
    one, W = 4000 none (every tile on the slow path)."""
    gen = torch.Generator(device=cuda).manual_seed(k * 1009 + w)
    data = torch.randint(-2**31, 2**31 - 1, (3001, w), dtype=torch.int32,
                         device=cuda, generator=gen)
    data[5] = -1
    lengths = _SEGMENT_LENGTHS + [0] * 300 + [2, 0, 5] * 200 + [700]
    for offset_dtype in (torch.int32, torch.int64):
        heads, offsets, tails = _segments(gen, cuda, 3001, k, lengths,
                                          offset_dtype)
        before = dict(fused_expr.FORM_LAUNCHES)
        got = fused_expr.fused_segment_popcount(data, heads, offsets, tails)
        key = f"segment/and{k}"
        assert fused_expr.FORM_LAUNCHES.get(key, 0) == before.get(key, 0) + 1
        want = ref.fused_segment_popcount(data, heads, offsets, tails)
        assert torch.equal(got, want)
        tuples = _expanded(heads, offsets, tails).contiguous()
        assert torch.equal(got, fused_expr.fused_gather_popcount(
            data, tuples, program.and_program(k)))


def test_segment_kernel_vector_widths_and_alignment(cuda):
    """16-byte loads where W % 4 == 0 and the matrix is 16-byte aligned,
    8-byte where W is even, else 4-byte: a matrix that starts 4 bytes into
    its storage reads 4 bytes at a time and gives the same popcounts."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    flat = torch.randint(-2**31, 2**31 - 1, (1 + 500 * 32,),
                         dtype=torch.int32, device=cuda, generator=gen)
    aligned = flat[:500 * 32].view(500, 32)
    shifted = flat[1:].view(500, 32)
    assert fused_expr.segment_layout(aligned)["vector_words"] == 4
    assert fused_expr.segment_layout(shifted)["vector_words"] == 1
    assert fused_expr.segment_layout(aligned[:, :30].contiguous())[
        "vector_words"] == 2
    assert fused_expr.segment_layout(aligned)["lanes_per_row"] == 8
    slots = {w: fused_expr.segment_layout(torch.zeros(
        (1, w), dtype=torch.int32, device=cuda))["slots"]
        for w in (32, 600, 2000, 4000)}
    assert slots == {32: 32, 600: 4, 2000: 1, 4000: 0}
    heads, offsets, tails = _segments(gen, cuda, 500, 3, [40, 0, 300, 2],
                                      torch.int64)
    for data in (aligned, shifted):
        assert torch.equal(
            fused_expr.fused_segment_popcount(data, heads, offsets, tails),
            ref.fused_segment_popcount(data, heads, offsets, tails))


def test_segment_kernel_launch_cuts_inside_segments(cuda):
    """Launches that cut a long segment (offsets clamped to each launch,
    as the clique passes do) give the popcounts of one launch."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    data = torch.randint(-2**31, 2**31 - 1, (1000, 32), dtype=torch.int32,
                         device=cuda, generator=gen)
    heads, offsets, tails = _segments(gen, cuda, 1000, 3,
                                      [5, 100_000, 0, 77, 1], torch.int64)
    whole = fused_expr.fused_segment_popcount(data, heads, offsets, tails)
    assert torch.equal(whole, ref.fused_segment_popcount(data, heads, offsets,
                                                         tails))
    for step in (1000, 4099, 65_536):
        parts = [fused_expr.fused_segment_popcount(
            data, heads, (offsets - s).clamp(0, tails[s:s + step].numel()),
            tails[s:s + step]) for s in range(0, tails.numel(), step)]
        assert torch.equal(torch.cat(parts), whole)


def test_segment_kernel_rejects_bad_operands(cuda):
    """T = 0 launches nothing; device mixes, wrong types and k > 4 raise."""
    data = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    heads = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    offsets = torch.tensor([0, 1, 3], device=cuda)
    tails = torch.zeros(3, dtype=torch.int32, device=cuda)
    before = dict(fused_expr.LAUNCHES)
    empty = fused_expr.fused_segment_popcount(data, heads[:0], offsets[:1],
                                              tails[:0])
    assert empty.shape == (0,) and empty.is_cuda
    assert fused_expr.LAUNCHES == before
    for args in ((data, heads.cpu(), offsets, tails),
                 (data, heads, offsets.cpu(), tails),
                 (data.cpu(), heads, offsets, tails),
                 (data, heads, offsets.float(), tails),
                 (data, heads.long(), offsets, tails),
                 (data, heads, offsets, tails.long()),
                 (data, torch.zeros((2, 4), dtype=torch.int32, device=cuda),
                  offsets, tails),
                 (data, heads[:, :1].t(), offsets[:2], tails)):
        with pytest.raises(ValueError):
            fused_expr.fused_segment_popcount(*args)
    assert fused_expr.LAUNCHES == before


def _minhash_rows(gen, device, e: int, k: int, sentinel: int):
    """Row pairs drawn from [-40, sentinel + 40): negative ids, pads above
    the sentinel, duplicates; every 13th row all sentinel, and b copying
    about half of a's positions so aligned matches occur."""
    a = torch.randint(-40, sentinel + 40, (e, k), dtype=torch.int32,
                      device=device, generator=gen)
    b = torch.randint(-40, sentinel + 40, (e, k), dtype=torch.int32,
                      device=device, generator=gen)
    same = torch.rand((e, k), device=device, generator=gen) < 0.5
    b = torch.where(same, a, b)
    a[::13] = sentinel
    b[5::13] = sentinel
    return a, b


@pytest.mark.parametrize("k", [1, 4, 7, 24, 28, 31, 32, 33, 128, 256])
@pytest.mark.parametrize("e", [0, 1, 999, 65_537])
def test_minhash_kernels_equal_plain_versions(cuda, k, e):
    """Both MinHash counts equal their plain versions for every k (below,
    at and above a warp) and ragged E, E = 0 included; each launch counts
    once, and E = 0 launches nothing."""
    gen = torch.Generator(device=cuda).manual_seed(k * 100_003 + e)
    a, b = _minhash_rows(gen, cuda, e, k, sentinel=150)
    for name in ("mh_intersect_pairs", "khash_match_pairs"):
        before = mh_intersect.LAUNCHES[name]
        got = getattr(mh_intersect, name)(a, b, 150)
        assert got.dtype == torch.int32 and got.shape == (e,)
        assert torch.equal(got, getattr(ref, name)(a, b, 150))
        assert torch.equal(getattr(ops, name)(a, b, 150), got)
        assert mh_intersect.LAUNCHES[name] == before + 2 * (e > 0)


@pytest.mark.parametrize("k", [1, 4, 7, 24, 28, 31, 32, 33, 128, 256])
@pytest.mark.parametrize("e", [0, 1, 999, 65_537])
@pytest.mark.parametrize("shift", [False, True])
def test_minhash_gather_kernels_equal_plain_versions(cuda, k, e, shift):
    """Both gather forms equal their plain versions (gather_rows, then the
    rows count) for every k and ragged E, with ids outside [0, n) clamped,
    pairs (u, u), and (``shift``) a sketch matrix and a rows operand whose
    base is shifted by 4 bytes; the rows form equals them on the same
    rows. Each launch counts once under its count and its form; E = 0
    launches nothing."""
    gen = torch.Generator(device=cuda).manual_seed(k * 100_003 + e + shift)
    n = 5_003
    data, _ = _minhash_rows(gen, cuda, n, k, sentinel=150)
    data[1] = torch.where(data[1] < 0, data[0], data[1])
    pairs = torch.randint(-3, n + 3, (e, 2), dtype=torch.int32, device=cuda,
                          generator=gen)
    pairs[::7, 1] = pairs[::7, 0]
    if shift:
        data = _shifted(data)
    for name in ("mh_intersect_pairs", "khash_match_pairs"):
        gather = name.replace("_pairs", "_gather")
        mh_intersect.reset_launch_counts()
        got = getattr(mh_intersect, gather)(data, pairs, 150)
        assert got.dtype == torch.int32 and got.shape == (e,)
        want = getattr(ref, gather)(data, pairs, 150)
        assert torch.equal(got, want)
        a = ref.gather_rows(data, pairs[:, 0])
        b = ref.gather_rows(data, pairs[:, 1])
        if shift:
            a = _shifted(a)
        assert torch.equal(getattr(mh_intersect, name)(a, b, 150), want)
        assert torch.equal(getattr(ops, gather)(data, pairs, 150), want)
        assert mh_intersect.LAUNCHES[name] == 3 * (e > 0)
        assert mh_intersect.FORM_LAUNCHES == (
            {f"{name}/gather": 2, f"{name}/rows": 1} if e else {})


def test_minhash_gather_known_counts(cuda):
    """The gather form reads rows by id: duplicates count with
    multiplicity, negative entries are valid, out-of-range ids clamp."""
    data = torch.tensor([[3, 3, -2, 9], [3, -2, 3, 7], [9, 9, 9, 9]],
                        dtype=torch.int32, device=cuda)
    pairs = torch.tensor([[0, 1], [2, 2], [-5, 1], [0, 7]],
                         dtype=torch.int32, device=cuda)
    assert mh_intersect.mh_intersect_gather(data, pairs, 9).tolist() == \
        [5, 0, 5, 0]
    assert mh_intersect.khash_match_gather(data, pairs, 9).tolist() == \
        [1, 0, 1, 0]
    assert mh_intersect.mh_intersect_gather(data, pairs, 10).tolist() == \
        [5, 16, 5, 4]


def test_minhash_kernels_known_counts(cuda):
    """Duplicates count with multiplicity; negative ids are valid; ids at
    or above the sentinel never match."""
    a = torch.tensor([[3, 3, -2, 9], [9, 9, 9, 9]], dtype=torch.int32,
                     device=cuda)
    b = torch.tensor([[3, -2, 3, 7], [9, 9, 9, 9]], dtype=torch.int32,
                     device=cuda)
    assert mh_intersect.mh_intersect_pairs(a, b, 9).tolist() == [5, 0]
    assert mh_intersect.khash_match_pairs(a, b, 9).tolist() == [1, 0]
    assert mh_intersect.mh_intersect_pairs(a, b, 10).tolist() == [5, 16]


def test_minhash_session_kernel_path_equals_plain_path(cuda):
    """kh and 1h-naive sessions launch their kernels once per chunk; the
    per-edge estimates equal the plain path's (same integer counts, same
    float ops) and TC agrees within rtol 1e-5 (float sums)."""
    g = TG.kronecker(12, 16, seed=1, device=cuda)
    for kind, name, kw in (("kh", "khash_match_pairs", {}),
                           ("1h", "mh_intersect_pairs",
                            {"variant": "naive"})):
        sess = TE.session(g, kind, storage_budget=1.0, device=cuda, **kw)
        mh_intersect.reset_launch_counts()
        cards = sess.edge_cardinalities()
        chunks = -(-g.m // sess.plan.edge_chunk)
        assert mh_intersect.LAUNCHES[name] == chunks
        assert mh_intersect.FORM_LAUNCHES == {f"{name}/gather": chunks}
        plain = TE.MiningSession(g, sess.sketch,
                                 sess.plan.with_(use_kernel=False))
        assert torch.equal(cards, plain.edge_cardinalities())
        assert float(sess.triangle_count()) == pytest.approx(
            float(plain.triangle_count()), rel=1e-5)


def test_minhash_kernels_reject_bad_operands(cuda):
    """Mixed devices, shapes or types raise before any launch."""
    a = torch.zeros((4, 3), dtype=torch.int32, device=cuda)
    before = dict(mh_intersect.LAUNCHES)
    for bad in (a.cpu(), a[:, :2], a.to(torch.int64)):
        with pytest.raises(ValueError):
            mh_intersect.mh_intersect_pairs(a, bad, 5)
        with pytest.raises(ValueError):
            mh_intersect.khash_match_pairs(a, bad, 5)
    pairs = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    for data, p in ((a, pairs.cpu()), (a, pairs[:, :1]), (a, pairs.long()),
                    (a.to(torch.int64), pairs), (a[:0], pairs)):
        for fn in (mh_intersect.mh_intersect_gather,
                   mh_intersect.khash_match_gather):
            with pytest.raises(ValueError):
                fn(data, p, 5)
    assert mh_intersect.LAUNCHES == before


_ATTN_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
             torch.bfloat16: dict(atol=1e-3, rtol=1e-2)}
_ROUTE = {torch.float32: "fma_fp32", torch.bfloat16: "wgmma_bf16"}


def _assert_attn_close(got, want, v):
    """The dtype's tolerance (module docstring); bfloat16 atol grows with
    max|v| and its mean error stays <= 1e-3."""
    tol = dict(_ATTN_TOL[want.dtype])
    if want.dtype == torch.bfloat16:
        tol["atol"] += 2.0 ** -8 * float(v.float().abs().max())
        mean = float((got.float() - want.float()).abs().mean())
        assert mean <= 1e-3, f"mean |kernel - plain| {mean}"
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _qkv(gen, device, dtype, b, sq, skv, h, kv, d):
    def draw(s, heads):
        return torch.randn((b, s, heads, d), device=device,
                           generator=gen).to(dtype)
    return draw(sq, h), draw(skv, kv), draw(skv, kv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 120, 128, 256])
@pytest.mark.parametrize("h,kv", [(2, 2), (4, 2), (4, 1), (6, 2), (8, 1)])
@pytest.mark.parametrize("s,window", [(1, 0), (97, 8), (1000, 0),
                                      (1000, 4096), (300, 1)])
def test_flash_kernel_equals_plain_version(cuda, dtype, d, h, kv, s, window):
    """MHA, GQA (also 3 groups) and MQA (also 8 query heads, which the
    float32 kernel packs into one block), head dims below, at and above a
    warp (120 is no multiple of 32; 256 needs > 48 KB of shared memory),
    ragged S, with and without a window: the kernel equals the plain
    version, in q's dtype, and counts one launch on its dtype's route
    (bfloat16: the wgmma kernel; float32: the CUDA-core kernel)."""
    gen = torch.Generator(device=cuda).manual_seed(d * 1009 + s + window)
    q, k, v = _qkv(gen, cuda, dtype, 2, s, s, h, kv, d)
    before = flash_attention.LAUNCHES["flash_attention"]
    routes = dict(flash_attention.ROUTE_LAUNCHES)
    got = flash_attention.flash_attention(q, k, v, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    assert flash_attention.LAUNCHES["flash_attention"] == before + 1
    routes[_ROUTE[dtype]] += 1
    assert flash_attention.ROUTE_LAUNCHES == routes
    _assert_attn_close(got, ref.causal_attention(q, k, v, window), v)


@pytest.mark.parametrize("d,cut", [(30, None), (31, None), (40, (2, 32)),
                                   (40, (1, 31))])
@pytest.mark.parametrize("window", [0, 7])
def test_flash_fp32_rows_not_16_byte_aligned(cuda, d, cut, window):
    """float32 rows whose start is not a 16-byte multiple (D = 30 and 31,
    and q, k, v as [..., 2:32] or [..., 1:31] views of D = 40 tensors): the
    kernel copies K/V tiles 8 or 4 bytes at a time and equals the plain
    version, reading the views in place (one launch, no copy)."""
    gen = torch.Generator(device=cuda).manual_seed(d * 31 + window)
    q, k, v = _qkv(gen, cuda, torch.float32, 2, 300, 300, 6, 2, d)
    if cut:
        q, k, v = (x[..., cut[0]:cut[1]] for x in (q, k, v))
        assert all(x.data_ptr() % 16 for x in (q, k, v))
    before = flash_attention.ROUTE_LAUNCHES["fma_fp32"]
    got = flash_attention.flash_attention(q, k, v, window=window)
    assert flash_attention.ROUTE_LAUNCHES["fma_fp32"] == before + 1
    torch.testing.assert_close(got, ref.causal_attention(q, k, v, window),
                               **_ATTN_TOL[torch.float32])


@pytest.mark.parametrize("sq,skv,window", [(200, 70, 0), (70, 200, 0),
                                           (200, 70, 8), (130, 1, 3),
                                           (1, 130, 0)])
def test_flash_folded_ragged_and_keyless_rows(cuda, sq, skv, window):
    """The folded layout with Sq != Skv: rows past Skv + window see no key
    and average every value, as the reference's softmax gives."""
    gen = torch.Generator(device=cuda).manual_seed(sq * 7 + skv)
    q = torch.randn((6, sq, 40), device=cuda, generator=gen)
    k = torch.randn((3, skv, 40), device=cuda, generator=gen)
    v = torch.randn((3, skv, 40), device=cuda, generator=gen)
    got = flash_attention.flash_attention_folded(q, k, v, groups=2,
                                                 window=window)
    want = ref.flash_attention_folded(q, k, v, groups=2, window=window)
    torch.testing.assert_close(got, want, **_ATTN_TOL[torch.float32])


@pytest.mark.parametrize("sq,skv,window", [(200, 70, 8), (300, 129, 5),
                                           (130, 1, 3), (70, 200, 9)])
def test_flash_bf16_folded_ragged_and_keyless_rows(cuda, sq, skv, window):
    """The bfloat16 kernel on the folded layout with Sq != Skv and a
    window: rows past Skv + window see no key and average every value;
    TMA zero-fills the keys past Skv and the kernel gives them weight 0."""
    gen = torch.Generator(device=cuda).manual_seed(sq * 11 + skv)
    q, k, v = (torch.randn((n, s, 64), device=cuda, generator=gen).to(
        torch.bfloat16) for n, s in ((6, sq), (3, skv), (3, skv)))
    before = flash_attention.ROUTE_LAUNCHES["wgmma_bf16"]
    got = flash_attention.flash_attention_folded(q, k, v, groups=2,
                                                 window=window)
    assert flash_attention.ROUTE_LAUNCHES["wgmma_bf16"] == before + 1
    want = ref.flash_attention_folded(q, k, v, groups=2, window=window)
    _assert_attn_close(got, want, v)
    if sq > skv + window:
        mean = v.float().mean(dim=1).repeat_interleave(2, dim=0)
        _assert_attn_close(got[:, skv + window:],
                           mean[:, None].expand(-1, sq - skv - window, -1)
                           .to(torch.bfloat16), v)


def test_flash_bf16_pads_head_dim_to_multiple_of_8(cuda):
    """D = 100 breaks TMA's 16-byte rule: the wrapper runs the kernel on a
    zero-padded copy (D = 104) and returns D = 100, scaled by 1/sqrt(100),
    on the same route."""
    gen = torch.Generator(device=cuda).manual_seed(100)
    q, k, v = _qkv(gen, cuda, torch.bfloat16, 1, 333, 333, 4, 2, 100)
    assert not flash_attention.tma_ready(q)
    before = flash_attention.ROUTE_LAUNCHES["wgmma_bf16"]
    got = flash_attention.flash_attention(q, k, v, window=40)
    assert flash_attention.ROUTE_LAUNCHES["wgmma_bf16"] == before + 1
    assert got.shape == q.shape and got.is_contiguous()
    _assert_attn_close(got, ref.causal_attention(q, k, v, 40), v)


def test_flash_bf16_reads_strided_inputs_deterministically(cuda):
    """Heads 8:10 and 10:12 of a 12-head tensor (D = 64) meet TMA's rules
    and are read in place; the kernel has no atomics, so the result equals
    the contiguous inputs' bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    wide = torch.randn((2, 333, 12, 64), device=cuda,
                       generator=gen).to(torch.bfloat16)
    q, k, v = wide[:, :, 0:8], wide[:, :, 8:10], wide[:, :, 10:12]
    assert not q.is_contiguous()
    assert all(flash_attention.tma_ready(x) for x in (q, k, v))
    got = flash_attention.flash_attention(q, k, v, window=50)
    want = flash_attention.flash_attention(q.contiguous(), k.contiguous(),
                                           v.contiguous(), window=50)
    assert torch.equal(got, want)
    assert torch.equal(got, flash_attention.flash_attention(q, k, v,
                                                            window=50))


def test_flash_reads_strided_inputs(cuda):
    """Non-contiguous heads (a slice of a wider tensor) are read in place
    through their strides; the result equals the contiguous inputs'."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    wide = torch.randn((2, 333, 12, 64), device=cuda, generator=gen)
    q, k, v = wide[:, :, 0:8], wide[:, :, 8:10], wide[:, :, 10:12]
    assert not q.is_contiguous()
    got = flash_attention.flash_attention(q, k, v, window=50)
    want = flash_attention.flash_attention(q.contiguous(), k.contiguous(),
                                           v.contiguous(), window=50)
    assert torch.equal(got, want)


def test_flash_rejects_bad_operands(cuda):
    """Wrong types, devices, head dims or windows raise before a launch."""
    q = torch.zeros((1, 8, 2, 16), device=cuda)
    before = dict(flash_attention.LAUNCHES)
    for args, kw in (((q, q.cpu(), q), {}), ((q, q.half(), q.half()), {}),
                     ((q.half(),) * 3, {}), ((q, q, q), {"window": -1}),
                     ((torch.zeros((1, 8, 2, 300), device=cuda),) * 3, {}),
                     ((q, q[:, :, :1].expand(1, 8, 3, 16),
                       q[:, :, :1].expand(1, 8, 3, 16)), {})):
        with pytest.raises(ValueError):
            flash_attention.flash_attention(*args, **kw)
    assert flash_attention.LAUNCHES == before


def test_clique_kernel_path_equals_plain_path(cuda, monkeypatch):
    """Bloom 4- and 5-cliques and the k-Hash 4-clique on the card launch
    the segmented AND3 / AND4 kernel and no [T, k] gather (k-Hash: the
    aligned-match kernel) and equal the plain path bit for bit: the same
    integer popcounts and match counts feed the same float ops in the same
    order."""
    g = TG.kronecker(11, 16, seed=1, device=cuda)
    sess = TE.session(g, "bf", storage_budget=0.5, device=cuda)
    plain = TE.MiningSession(g, sess.sketch,
                             sess.plan.with_(use_kernel=False))
    # small pieces and launches: several launches per pass, some of
    # them cutting a segment
    monkeypatch.setattr(cliques, "_CHUNK_CANDIDATES", 1 << 16)
    monkeypatch.setattr(cliques, "_LAUNCH_TUPLES", 1 << 14)
    for method, form in (("four_clique_count", "segment/and3"),
                         ("five_clique_count", "segment/and4")):
        fused_expr.reset_launch_counts()
        got = getattr(sess, method)()
        assert fused_expr.FORM_LAUNCHES.get(form, 0) >= 2
        assert fused_expr.LAUNCHES["fused_gather_popcount"] == 0
        tuples = REGISTRY.gauge("clique_triangles").value
        assert tuples > 0
        assert torch.equal(got, getattr(plain, method)())
    kh = TE.session(g, "kh", storage_budget=0.5, device=cuda)
    mh_intersect.reset_launch_counts()
    got = kh.four_clique_count()
    assert mh_intersect.LAUNCHES["khash_match_pairs"] >= 3
    assert set(mh_intersect.FORM_LAUNCHES) == {"khash_match_pairs/rows"}
    assert torch.equal(got, TE.MiningSession(
        g, kh.sketch, kh.plan.with_(use_kernel=False)).four_clique_count())


def test_clique_exact_counts_on_the_card(cuda):
    """The exact branch on the card equals the brute-force oracle."""
    g = TG.kronecker(8, 16, seed=1, device=cuda)
    want = TG.four_clique_count_bruteforce(g)
    assert float(cliques.four_clique_count(g)) == float(want)
    assert float(TE.session(g, None, device=cuda).four_clique_count()) == \
        float(want)


def test_sweep_kernel_equals_plain_version(cuda):
    """The Bloom sweep of local_cluster launches the dense AND2 kernel once
    per sweep (sparse and dense frontiers) and equals the plain path: the
    same popcounts on the sweep's real operands, and the same orders and
    conductance profiles."""
    from repro_torch.core.algorithms import localcluster as LC

    g = TG.kronecker(10, 16, seed=1, device=cuda)
    sess = TE.session(g, "bf", storage_budget=1.0, device=cuda)
    seeds = torch.arange(0, g.n, 37, device=cuda)
    for mode in ("sparse", "dense"):
        fused_expr.reset_launch_counts()
        got = sess.local_cluster(seeds, 0.15, 1e-4, frontier_mode=mode)
        assert fused_expr.LAUNCHES["fused_rows_popcount"] == 1
        assert fused_expr.FORM_LAUNCHES == {"rows/and2": 1}
        # the plain path on the same push output
        ppr = got.frontier if mode == "sparse" else got.ppr
        order, phi, support = LC.sweep_cut(
            g, ppr, sess.sketch, sess.plan.with_(use_kernel=False))
        assert torch.equal(order, got.order)
        assert torch.equal(phi, got.conductance)
        assert torch.equal(support, got.support)
    nbr, prefix = LC.sweep_operands(sess.sketch, got.order)
    prog = program.and_program(2)
    assert torch.equal(fused_expr.fused_rows_popcount([nbr, prefix], prog),
                       ref.fused_rows_popcount([nbr, prefix], prog))


def test_exact_session_equals_brute_force(cuda):
    """At scale 10 on the card the exact session's per-edge counts equal
    set intersections of the CSR rows, its TC and exact_triangle_count
    equal trace(A³)/6, and Adamic–Adar / Resource-Allocation equal sums
    over those intersections; the exact paths launch no kernel."""
    import numpy as np

    from repro_torch.core import exact

    g = TG.kronecker(10, 16, seed=1, device=cuda)
    fused_expr.reset_launch_counts()
    sess = TE.session(g, None, device=cuda)
    cards = sess.edge_cardinalities().cpu().numpy()
    rows = [set(TG.neighbors_np(g, v).tolist()) for v in range(g.n)]
    edges = g.edges.cpu().numpy()
    assert cards.tolist() == [len(rows[u] & rows[v]) for u, v in edges]
    a = torch.zeros((g.n, g.n), dtype=torch.float64, device=cuda)
    a[g.edges[:, 0].long(), g.edges[:, 1].long()] = 1
    a[g.edges[:, 1].long(), g.edges[:, 0].long()] = 1
    tc = round(float(torch.trace(a @ a @ a)) / 6)
    assert int(exact.exact_triangle_count(g)) == tc
    assert float(sess.triangle_count()) == tc
    deg = g.deg.cpu().numpy().astype(np.float64)
    pairs = np.concatenate([edges[:500], np.random.default_rng(0).integers(
        0, g.n, (200, 2))]).astype(np.int32)
    common = [sorted(rows[u] & rows[v]) for u, v in pairs]
    for measure, weight in (
            ("adamic_adar",
             lambda d: 1.0 / np.maximum(np.log(np.maximum(d, 2.0)), 1e-6)),
            ("resource_alloc", lambda d: 1.0 / np.maximum(d, 1.0))):
        want = [weight(deg[c]).sum() for c in common]
        got = sess.similarity(torch.from_numpy(pairs).to(cuda), measure)
        assert np.allclose(got.cpu().numpy(), want, rtol=1e-5, atol=0)
    assert sum(fused_expr.LAUNCHES.values()) == 0


def test_stream_on_the_card_equals_the_cpu_stream(cuda):
    """A Bloom and a k-Hash stream on the card (inserts, deletions, a
    server flush) give the CPU stream's sketch rows, device CSR and
    integer answers, with the AND2 gather (pair batch), its fused form
    (``gather/and2/card``, the Bloom refresh), the dense AND2 (sweep) and
    the k-Hash gather launched. The Bloom stream's AND2
    popcounts of its query pairs and live edges are equal on both, and its
    served pair answers and refreshed per-edge cardinalities agree within
    ROADMAP difference 2 (an ulp of ``log1p``: rtol 1e-6)."""
    import numpy as np

    from repro_torch.kernels import mh_intersect
    from repro_torch.stream import BatchedQueryServer, DynamicGraph, \
        StreamSession

    g = TG.kronecker(10, 16, seed=1, device="cpu")
    edges = g.edges.numpy().astype(np.int64)
    for kind, key in (("bf", "gather/and2"),
                      ("kh", "khash_match_pairs/gather")):
        out = {}
        for dev in ("cpu", cuda):
            st = StreamSession(DynamicGraph.from_edges(g.n, edges[:9000],
                                                       device=dev),
                               kind, storage_budget=1.0)
            srv = BatchedQueryServer(st, min_batch=8)
            st.session.edge_cardinalities()
            fused_expr.reset_launch_counts()
            mh_intersect.reset_launch_counts()
            rng = np.random.default_rng(3)
            for chunk in np.array_split(edges[9000:], 2):
                cur = st.dyn.edge_array()
                st.apply_delta(chunk, cur[rng.choice(cur.shape[0], 50,
                                                     replace=False)])
            pairs = rng.integers(0, g.n, (64, 2)).astype(np.int32)
            rid = srv.submit_similarity(pairs, "common")
            lc = srv.submit_local_cluster(5, 0.15, 1e-3)
            res = srv.flush()
            forms = {**fused_expr.FORM_LAUNCHES, **mh_intersect.FORM_LAUNCHES}
            view = st.graph
            ones = None
            if kind == "bf":
                ones = [TE.tuple_cardinality_ones(
                    st.sketch, t, st.session.plan).cpu()
                    for t in (torch.from_numpy(pairs).to(dev), view.edges)]
            out[str(dev)] = (st.sketch.data.cpu(), view.indices.cpu(),
                             view.indptr.cpu(), res[rid].value,
                             res[lc].value["size"], forms, ones,
                             st.session.edge_cardinalities().cpu().numpy())
            srv.close()
        cpu, card = out["cpu"], out[str(cuda)]
        for a, b in zip(cpu[:3], card[:3]):
            assert torch.equal(a, b), kind
        if kind == "kh":
            assert np.array_equal(cpu[3], card[3])   # integer match counts
        else:
            for a, b in zip(cpu[6], card[6]):        # AND2 popcounts
                assert torch.equal(a, b)
            assert np.allclose(card[3], cpu[3], rtol=1e-6, atol=0)
            assert np.allclose(card[7], cpu[7], rtol=1e-6, atol=0)
        assert cpu[4] == card[4]
        assert card[5].get(key, 0) > 0 and not cpu[5], (kind, card[5])
        if kind == "bf":
            assert card[5].get("rows/and2", 0) == 1
            assert card[5].get("gather/and2/card", 0) > 0   # the refresh


def test_from_edge_array_on_the_card_equals_the_cpu(cuda):
    """The static graph's keys, CSR and degrees sorted on the card equal
    the CPU's (duplicates, both directions, self loops and out-of-range
    ids in the input)."""
    import numpy as np

    rng = np.random.default_rng(0)
    edges = rng.integers(-2, 3000, size=(60000, 2))
    edges[:100] = edges[100:200, ::-1]
    cpu = TG.from_edge_array(2990, edges, device="cpu")
    card = TG.from_edge_array(2990, edges, device=cuda)
    for name in ("indptr", "indices", "deg", "edges"):
        assert torch.equal(getattr(cpu, name), getattr(card, name).cpu())
    assert (cpu.m, cpu.d_max) == (card.m, card.d_max)


def test_adaptive_pass_on_the_card_equals_the_cpu(cuda):
    """The adaptive Bloom built on the card has the CPU build's words and
    rows; its pair pass launches only the dense AND2 and gives the CPU's
    popcounts (integers, equal) and estimates (equal: the same float32
    operations on equal integers, up to difference 2's rtol 1e-6)."""
    import numpy as np

    from repro_torch.core import adaptive

    out = {}
    for dev in ("cpu", cuda):
        g = TG.kronecker(10, 16, seed=2, device=dev)
        sk = adaptive.build_adaptive_bloom(g, 1.0, num_hashes=2, seed=1)
        fused_expr.reset_launch_counts()
        ones, wt = adaptive.adaptive_pair_ones(sk, g.edges)
        forms = dict(fused_expr.FORM_LAUNCHES)
        vals = adaptive.adaptive_pair_cardinalities(sk, g.edges)
        out[str(dev)] = (sk.data.cpu(), sk.offsets.cpu(), ones.cpu(),
                         wt.cpu(), vals.cpu().numpy(), forms,
                         float(adaptive.adaptive_triangle_count(g, sk)))
    cpu, card = out["cpu"], out[str(cuda)]
    for a, b in zip(cpu[:4], card[:4]):
        assert torch.equal(a, b)
    assert np.allclose(card[4], cpu[4], rtol=1e-6, atol=0)
    assert card[6] == pytest.approx(cpu[6], rel=1e-6)
    assert not cpu[5] and set(card[5]) == {"rows/and2"}


def test_link_prediction_on_the_card_equals_the_cpu(cuda):
    """Candidates (identical, with hub rows cut across pieces too), the
    Bloom and k-Hash scorers' counts (identical) and ef (equal) on the
    card and on the CPU; the card launches the gather forms."""
    import numpy as np

    from repro_torch.core import sketches
    from repro_torch.core.algorithms import linkpred
    from repro_torch.kernels import mh_intersect

    out = {}
    for dev in ("cpu", cuda):
        g = TG.kronecker(9, 12, seed=4, device=dev)
        sparse, removed = linkpred.split_edges(g, 0.1, 0)
        cand = linkpred._distance2_candidates(sparse)
        small = linkpred._distance2_candidates(sparse, limit=1000)
        fused_expr.reset_launch_counts()
        mh_intersect.reset_launch_counts()
        ef = {kind: linkpred.link_prediction_effectiveness(
            g, sketch_kind=kind, storage_budget=0.5) for kind in
            (None, "bf", "kh")}
        forms = {**fused_expr.FORM_LAUNCHES, **mh_intersect.FORM_LAUNCHES}
        sk = sketches.build(sparse, "kh", 0.5, seed=0)
        counts = ops.khash_match_gather(sk.data, cand, sk.n)
        out[str(dev)] = (cand.cpu(), small.cpu(), removed, ef, forms,
                         counts.cpu())
    cpu, card = out["cpu"], out[str(cuda)]
    assert torch.equal(cpu[0], card[0]) and torch.equal(cpu[1], card[1])
    assert np.array_equal(cpu[2], card[2]) and torch.equal(cpu[5], card[5])
    assert cpu[3] == card[3]
    assert not cpu[4] and card[4].get("gather/and2/card", 0) > 0 \
        and card[4].get("khash_match_pairs/gather", 0) > 0


def test_dedup_on_the_card_equals_the_cpu(cuda):
    """Sketches, keep mask and stats of a corpus with planted
    near-duplicates, empty and short docs: identical on card and CPU."""
    import numpy as np

    from repro_torch.data import dedup

    rng = np.random.default_rng(0)
    docs = [rng.integers(0, 5000, size=rng.integers(200, 800))
            for _ in range(40)]
    for i in rng.choice(40, size=15, replace=False):
        d = docs[i].copy()
        idx = rng.choice(len(d), size=max(1, len(d) // 33), replace=False)
        d[idx] = rng.integers(0, 5000, size=len(idx))
        docs.append(d)
    docs += [np.zeros(0, np.int64), np.array([3, 4]), np.array([3, 4])]
    got = {str(dev): (dedup.document_sketches(docs, 265, device=dev),
                      dedup.minhash_dedup(docs, 0.7, 265, device=dev))
           for dev in ("cpu", cuda)}
    cpu, card = got["cpu"], got[str(cuda)]
    assert np.array_equal(cpu[0], card[0])
    assert np.array_equal(cpu[1][0], card[1][0]) and cpu[1][1] == card[1][1]
    assert card[1][1]["dropped"] >= 15


def test_stream_restore_on_the_card_equals_the_cpu(cuda, tmp_path):
    """A Bloom stream saved on the CPU restores on the card (and back):
    the same edge keys, degrees, CSR, sketch rows and bookkeeping, and
    after one more delta on each, the same rows and integer answers."""
    import numpy as np

    from repro_torch.stream import DynamicGraph, ErrorBudgetPolicy, \
        StreamSession

    g = TG.kronecker(10, 16, seed=1, device="cpu")
    edges = g.edges.numpy().astype(np.int64)
    st = StreamSession(DynamicGraph.from_edges(g.n, edges[:9000],
                                               device="cpu"), "bf",
                       storage_budget=1.0, policy=ErrorBudgetPolicy(50.0))
    rng = np.random.default_rng(3)
    st.apply_delta(edges[9000:9500], st.dyn.edge_array()[:40])
    st.save(str(tmp_path))
    card = StreamSession.restore(str(tmp_path), device=cuda)
    cpu = StreamSession.restore(str(tmp_path), device="cpu")
    for s in (card, cpu):
        s.session.edge_cardinalities()
        s.apply_delta(edges[9500:], s.dyn.edge_array()[::97])
    assert card.version == cpu.version == 2
    assert np.array_equal(card.dyn.edge_keys, cpu.dyn.edge_keys)
    for f in ("indptr", "indices", "deg", "edges"):
        assert torch.equal(getattr(card.graph, f).cpu(),
                           getattr(cpu.graph, f))
    assert torch.equal(card.sketch.data.cpu(), cpu.sketch.data)
    assert np.array_equal(card.maintainer.dirty, cpu.maintainer.dirty)
    assert card.maintainer.stats() == cpu.maintainer.stats()
    pairs = rng.integers(0, g.n, (64, 2)).astype(np.int32)
    ones = [TE.tuple_cardinality_ones(s.sketch, torch.from_numpy(pairs).to(
        s.dyn.torch_device), s.session.plan).cpu() for s in (card, cpu)]
    assert torch.equal(*ones)
    assert float(card.triangle_count()) == pytest.approx(
        float(cpu.triangle_count()), rel=1e-6)
    card.save(str(tmp_path / "back"))
    again = StreamSession.restore(str(tmp_path / "back"), device="cpu")
    assert torch.equal(again.sketch.data, cpu.sketch.data)


def test_sharded_path_on_the_card_equals_the_cpu(cuda, tmp_path):
    """At world size 1 on NCCL: the vertex-sharded build equals
    build_bloom on the CPU, mine() (AND2 gather launches only) the CPU's
    estimate, and the engine's sharded fold the local fold's float32 bits
    and the CPU fold within the reference's rtol 1e-5. More NCCL ranks
    than GPUs raise."""
    import torch.distributed as dist

    from repro_torch.core import sketches
    from repro_torch.core.algorithms.tc import triangle_count
    from repro_torch.distributed import sharding, spawn
    from repro_torch.distributed.spawn import init_group
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import mine

    host = TG.kronecker(10, 16, seed=1, device="cpu")
    card = host.to(cuda)
    # the CPU side first: with no process group it runs alone
    want = mine.mine(host, device="cpu")
    cpu = TE.session(host, "bf", storage_budget=0.25, device="cpu",
                     edge_chunk=1000, degree_order=True)
    cpu_tc = float(triangle_count(host, cpu.sketch, plan=cpu.plan))
    init_group("file://" + str(tmp_path / "store"), 1, 0, "cuda", 60.0)
    try:
        mesh = launch_mesh.make_host_mesh(1, 1, device=cuda)
        words = sketches.bloom_words_for_budget(host.n, host.m, 0.25)
        rows = mine.build_sketches_distributed(card, mesh, words, 2, 0)
        assert torch.equal(rows.cpu(), sketches.build_bloom(host, words))
        reset_launch_counts()
        got = mine.mine(card, mesh, device=cuda)
        counts = {k: v for k, v in launch_counts().items() if v}
        forms = dict(fused_expr.FORM_LAUNCHES)
        assert list(forms) == ["gather/and2"] and got["devices"] == 1
        assert counts == {"fused_gather_popcount": forms["gather/and2"]}
        assert got["words"] == want["words"]
        assert got["tc_estimate"] == pytest.approx(want["tc_estimate"],
                                                   rel=1e-6)
        sess = TE.session(card, "bf", storage_budget=0.25, device=cuda,
                          edge_chunk=1000)
        local = triangle_count(card, sess.sketch, plan=sess.plan)
        with sharding.use_rules(mesh):
            sharded = triangle_count(card, sess.sketch,
                                     plan=sess.plan.with_(shard_edges=True))
        assert sharded.view(torch.int32) == local.view(torch.int32)
        assert float(sharded) == pytest.approx(cpu_tc, rel=1e-5)
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="GPUs"):
        spawn(print, torch.cuda.device_count() + 1, device=cuda)


#: the card-vs-CPU model test's configs by dtype. In bfloat16 the MoE
#: layers are cut (``moe_layer_start`` past the last layer): at these
#: reduced configs the CPU's own bf16 logits lie 0.17-0.63 of max |logit|
#: from the float32 model on the same weights with the MoE layers, and
#: 0.013-0.043 without them (``tests/bf16_drift.py``): a rounding flips a
#: near-tied top-k choice and sends a token to another expert, which no
#: count of roundings bounds.
CARD_MODELS = {
    "float32": ("qwen3_8b", "h2o_danube3_4b", "phi35_moe", "deepseek_v3",
                "mamba2_130m", "jamba15_large"),
    "bfloat16": ("qwen3_8b", "h2o_danube3_4b", "phi35_moe", "deepseek_v3",
                 "mamba2_130m", "jamba15_large"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_on_the_card_equals_the_cpu(cuda, dtype):
    """Reduced configs on the card: qwen3_8b (qk-norm, GQA),
    h2o_danube3_4b (window 64), phi35_moe (MoE), deepseek_v3 (MLA, its
    v padded for the kernel; MoE with a shared expert), mamba2_130m (SSM)
    and jamba15_large (attention and SSM). The prefill forward launches the
    flash kernel once per attention or MLA layer, on the dtype's route,
    and its logits and 80 teacher-forced decode steps (past the ring
    buffer) equal the same model on the CPU. float32: within 1e-4 of max
    |logit| (the CPU parity tests' bound). bfloat16, MoE layers cut
    (``CARD_MODELS``): within 2L · 2^-8 of max |logit|, one bf16 rounding
    (2^-9 a side) of each of the 2L sublayers' outputs carried to the
    logits at gain 1; a config with SSD layers, which round about eight
    times along their chain, within twice the CPU's own bf16 error (max
    |bf16 - float32| over max |logit|, the same weights and inputs in
    float32 on the CPU; the largest over the decode steps for the steps)
    where that is larger: two bf16 runs that each lie within e of the
    float32 one lie within 2e of each other. The readings are printed."""
    import copy
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_params, layer_sigs, reduced)

    for arch in CARD_MODELS[dtype]:
        cfg = dataclasses.replace(
            reduced(configs.get(arch), layers=3, d_model=256, heads=4, kv=2,
                    ff=512, vocab=1000), dtype=dtype)
        if dtype == "bfloat16":
            cfg = dataclasses.replace(cfg, moe_layer_start=cfg.num_layers)
        attn = sum(m in ("attn", "mla") for m, _ in layer_sigs(cfg))
        host = init_params(cfg, 0, device="cpu")
        card = copy.deepcopy(host).to(cuda)
        v = cfg.vocab_size

        def gap(got, want):
            err = float((got.float().cpu() - want.float())[..., :v].abs()
                        .max())
            return err / max(float(want.float()[..., :v].abs().max()), 1.0)

        # S a multiple of the reduced configs' ssm_chunk of 8
        tokens = torch.randint(0, v, (2, 304 if cfg.ssm else 300),
                               generator=torch.Generator().manual_seed(3))
        with torch.inference_mode():
            def cpu_run(model, c):
                cache = init_cache(c, 2, 96, device="cpu")
                steps = []
                for i in range(80):
                    lg, cache = decode_step(model, cache, c,
                                            tokens[:, i:i + 1])
                    steps.append(lg)
                return forward(model, c, tokens), steps

            want, want_steps = cpu_run(host, cfg)
            tol = tol_steps = 1e-4 if dtype == "float32" else \
                2 * cfg.num_layers * 2.0 ** -8
            if dtype == "bfloat16" and cfg.ssm:
                exact, exact_steps = cpu_run(
                    copy.deepcopy(host).float(),
                    dataclasses.replace(cfg, dtype="float32"))
                e32 = gap(want, exact)
                e32_steps = max(map(gap, want_steps, exact_steps))
                tol, tol_steps = max(tol, 2 * e32), max(tol, 2 * e32_steps)
            flash_attention.reset_launch_counts()
            got = forward(card, cfg, tokens.to(cuda))
            torch.cuda.synchronize()
            assert flash_attention.ROUTE_LAUNCHES == {
                "wgmma_bf16": attn * (dtype == "bfloat16"),
                "fma_fp32": attn * (dtype == "float32")}, arch
            err = gap(got, want)
            assert (got[..., v:] == -1e30).all(), arch
            cc = init_cache(cfg, 2, 96, device=cuda)
            err_steps = 0.0
            for i in range(80):
                got, cc = decode_step(card, cc, cfg,
                                      tokens[:, i:i + 1].to(cuda))
                assert (got[..., v:] == -1e30).all(), (arch, i)
                err_steps = max(err_steps, gap(got, want_steps[i]))
            print(f"{arch} {dtype}: card vs CPU, forward {err:.4g} (bound "
                  f"{tol:.4g}), decode steps {err_steps:.4g} (bound "
                  f"{tol_steps:.4g}) of max |logit|")
            assert err <= tol, (arch, "forward", err, tol)
            assert err_steps <= tol_steps, (arch, "decode", err_steps,
                                            tol_steps)
            assert flash_attention.LAUNCHES["flash_attention"] == attn


#: the flash gradient's cases on the card, (B, S, H, KV, D, Dv, window):
#: GQA, S = 2,500 (two blocks of the plain backward), a window, and MLA's
#: narrow v (Dv 128 against D 192, padded by ``AttentionCore``)
_GRAD_CASES = [(2, 300, 4, 2, 64, 64, 0), (1, 2500, 4, 1, 128, 128, 0),
               (2, 700, 4, 4, 64, 64, 96), (1, 513, 8, 8, 192, 128, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_gradient_equals_plain_autograd(cuda, dtype):
    """``FlashAttentionFn`` on the card (the kernel's forward, one launch
    on the dtype's route; the plain recompute's backward) against autograd
    through ``ref.causal_attention`` on the same tensors: the output within
    the forward's tolerance; dq, dk, dv in the inputs' dtype, float32
    within 1e-5 · max |plain| (the same float32 arithmetic in other
    blocks), bfloat16 within one bf16 ulp (2^-7 of the value: both round
    a float32 gradient once) plus 1e-6 · max |plain|."""
    import torch.nn.functional as F

    from repro_torch.models.layers import AttentionCore

    for b, s, h, kv, d, dv, window in _GRAD_CASES:
        gen = torch.Generator(device=cuda).manual_seed(s + d)

        def draw(*shape):
            return torch.randn(shape, device=cuda, generator=gen).to(dtype)
        q, k, v = draw(b, s, h, d), draw(b, s, kv, d), draw(b, s, kv, dv)
        dout = draw(b, s, h, dv)
        for x in (q, k, v):
            x.requires_grad_()
        before = flash_attention.ROUTE_LAUNCHES[_ROUTE[dtype]]
        out = AttentionCore(window)(q, k, v)
        assert flash_attention.ROUTE_LAUNCHES[_ROUTE[dtype]] == before + 1
        got = torch.autograd.grad(out, (q, k, v), dout)
        want_out = ref.causal_attention(q, k, F.pad(v, (0, d - dv)),
                                        window)[..., :dv]
        want = torch.autograd.grad(want_out, (q, k, v), dout)
        _assert_attn_close(out.detach(), want_out.detach(), v.detach())
        for name, g, w in zip("qkv", got, want):
            assert g.dtype == dtype and g.shape == w.shape, name
            diff = (g.float() - w.float()).abs()
            scale = float(w.float().abs().max())
            if dtype == torch.float32:
                assert float(diff.max()) <= 1e-5 * scale, (name, s)
            else:
                assert bool((diff <= 2.0 ** -7 * w.float().abs()
                             + 1e-6 * scale).all()), (name, s,
                                                      float(diff.max()))


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("arch", ["qwen3_8b", "phi35_moe", "deepseek_v3",
                                  "mamba2_130m"])
def test_train_step_on_the_card_equals_the_cpu(cuda, arch):
    """A reduced float32 ``make_train_step`` step (Adafactor, lr 1e-2,
    remat on) on the card against the same step on the CPU from the same
    state. The attention and MLA layers launch the float32 kernel twice
    each (forward and remat). Every gradient lies within 1e-4 · max |CPU|
    of the CPU's (float32 in another summation order; observed <= 5e-6);
    loss and ``grad_norm`` within rtol 1e-4. The parameters agree within
    1e-4 · max |CPU| on all but 1e-3 of each tensor's elements and within
    2.1 · lr everywhere: Adafactor's first update of an unfactored leaf is
    lr · g / |g|, so a gradient that is zero up to its float32 error
    (about 1 element a config in these runs) may step the other way."""
    import copy
    import dataclasses

    from repro_torch import configs
    from repro_torch.distributed.step import init_train_state, \
        make_train_step
    from repro_torch.models import layer_sigs, loss_fn, reduced
    from repro_torch.optim import Adafactor

    cfg = dataclasses.replace(
        reduced(configs.get(arch), layers=3, d_model=256, heads=4, kv=2,
                ff=512, vocab=1000), dtype="float32")
    lr = 1e-2
    opt = Adafactor(learning_rate=lr)
    host = init_train_state(cfg, opt, 0, device="cpu")
    card = {"params": copy.deepcopy(host["params"]).to(cuda),
            "opt": _tree_to(host["opt"], cuda)}
    gen = torch.Generator().manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
             for k in ("inputs", "labels")}
    card_batch = _tree_to(batch, cuda)
    for (name, p), g, w in zip(
            host["params"].named_parameters(),
            torch.autograd.grad(loss_fn(card["params"], cfg, card_batch),
                                list(card["params"].parameters())),
            torch.autograd.grad(loss_fn(host["params"], cfg, batch),
                                list(host["params"].parameters()))):
        err = float((g.cpu() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (arch, name, err)
    attn = sum(m in ("attn", "mla") for m, _ in layer_sigs(cfg))
    step = make_train_step(cfg, opt)
    flash_attention.reset_launch_counts()
    card, got = step(card, card_batch)
    torch.cuda.synchronize()
    assert flash_attention.ROUTE_LAUNCHES == {"wgmma_bf16": 0,
                                              "fma_fp32": 2 * attn}, arch
    host, want = step(host, batch)
    for key in ("loss", "grad_norm"):
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-4)
    cpu = dict(host["params"].named_parameters())
    for name, p in card["params"].named_parameters():
        w = cpu[name].detach()
        diff = (p.detach().cpu() - w).abs()
        off = diff > 1e-4 * float(w.abs().max())
        assert float(diff.max()) <= 2.1 * lr and \
            float(off.float().mean()) <= 1e-3, (arch, name,
                                               float(diff.max()))


def test_every_parameter_gets_a_gradient_on_the_card(cuda):
    """Every family in bfloat16 on the card: ``loss_fn``'s gradient reaches
    every parameter, finite and not all zero (the projections behind q, k
    and v get theirs through the kernel's Function), and the attention
    and MLA layers launch the bf16 kernel twice each under remat."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import init_params, layer_sigs, loss_fn, reduced

    for arch in ("qwen3_8b", "gemma_2b", "h2o_danube3_4b", "qwen2_vl_72b",
                 "phi35_moe", "deepseek_v3", "mamba2_130m", "jamba15_large"):
        cfg = dataclasses.replace(reduced(configs.get(arch), layers=3),
                                  dtype="bfloat16")
        model = init_params(cfg, 0, device=cuda).requires_grad_()
        gen = torch.Generator(device=cuda).manual_seed(1)
        s = 64
        inputs = (torch.randint(0, cfg.vocab_size, (2, s), device=cuda,
                                generator=gen)
                  if cfg.input_mode == "tokens" else
                  torch.randn((2, s, cfg.d_model), device=cuda,
                              generator=gen))
        batch = {"inputs": inputs,
                 "labels": torch.randint(0, cfg.vocab_size, (2, s),
                                         device=cuda, generator=gen)}
        attn = sum(m in ("attn", "mla") for m, _ in layer_sigs(cfg))
        names, params = zip(*model.named_parameters())
        flash_attention.reset_launch_counts()
        grads = torch.autograd.grad(loss_fn(model, cfg, batch), params)
        torch.cuda.synchronize()
        assert flash_attention.ROUTE_LAUNCHES["wgmma_bf16"] == 2 * attn, arch
        for name, g in zip(names, grads):
            assert g is not None and bool(torch.isfinite(g).all()) and \
                bool(g.abs().amax() > 0), (arch, name)


def test_flash_under_local_map_equals_plain(cuda):
    """The attention core on DTensors of a fake 2×2 group on the card:
    each rank's kernel launch on its 2 query heads and the kv head they
    read (4 heads over "model", one kv head gathered) equals the plain
    version on the same local tensors (the bf16 tolerance above)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import fake_group, make_host_mesh
    from repro_torch.models.layers import AttentionCore

    gen = torch.Generator(device=cuda).manual_seed(5)
    with fake_group(4):
        mesh = make_host_mesh(2, 2, device=cuda)

        def rand(heads):
            return torch.randn((2, 256, heads, 128), generator=gen,
                               device=cuda, dtype=torch.bfloat16)

        ql, kl, vl = rand(2), rand(1), rand(1)
        q = DTensor.from_local(ql, mesh, [Shard(0), Shard(2)],
                               run_check=False)
        k = DTensor.from_local(kl, mesh, [Shard(0), Replicate()],
                               run_check=False)
        v = DTensor.from_local(vl, mesh, [Shard(0), Replicate()],
                               run_check=False)
        flash_attention.reset_launch_counts()
        with sharding.use_rules(mesh), torch.no_grad():
            out = AttentionCore(0)(q, k, v)
        torch.cuda.synchronize()
        assert flash_attention.ROUTE_LAUNCHES == {"wgmma_bf16": 1,
                                                  "fma_fp32": 0}
        assert out.placements == (Shard(0), Shard(2))
        got = out.to_local().float()
    want = ref.causal_attention(ql, kl, vl, 0).float()
    tol = 1e-3 + 2.0 ** -8 * float(vl.float().abs().max())
    torch.testing.assert_close(got, want, atol=tol, rtol=1e-2)
    assert float((got - want).abs().mean()) <= 1e-3


def test_local_shard_step_on_the_card(cuda):
    """A reduced bfloat16 ``qwen3_8b`` train step as rank 0 of a fake
    (2, 2) group on the card (``launch.dryrun.run_local_shard``): its
    shards on the card, the kernel launched twice a layer (forward and
    remat), its time and peak memory reported. The other ranks are
    fake, so the loss is not checked."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models import ShapeConfig, reduced

    cfg = dataclasses.replace(reduced(configs.get("qwen3_8b"), layers=2),
                              dtype="bfloat16")
    flash_attention.reset_launch_counts()
    res = dryrun.run_local_shard(cfg, ShapeConfig("t", 128, 8, "train"),
                                 mesh_shape=(2, 2), steps=2, device=cuda)
    assert flash_attention.ROUTE_LAUNCHES == {"wgmma_bf16": 2 * 2 * 2,
                                              "fma_fp32": 0}
    assert res["local_batch"] == (4, 128) and res["peak_bytes"] > 0
    assert len(res["step_s"]) == 2 and all(t > 0 for t in res["step_s"])
