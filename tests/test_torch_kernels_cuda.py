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
"""
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
    """A CUDA session uses the kernels; its per-edge popcounts equal the
    plain path's and TC agrees within rtol 1e-5 (float sums)."""
    g = TG.kronecker(12, 16, seed=1, device=cuda)
    sess = TE.session(g, "bf", storage_budget=0.25, device=cuda)
    assert sess.plan.use_kernel and sess.plan.degree_order
    fused_expr.reset_launch_counts()
    tc = float(sess.triangle_count())
    assert fused_expr.LAUNCHES["fused_gather_popcount"] >= 1
    plain = sess.plan.with_(use_kernel=False)
    assert torch.equal(TE.tuple_cardinality_ones(sess.sketch, g.edges,
                                                 sess.plan),
                       TE.tuple_cardinality_ones(sess.sketch, g.edges, plain))
    tc_plain = float(TE.MiningSession(g, sess.sketch, plain).triangle_count())
    assert tc == pytest.approx(tc_plain, rel=1e-5)


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
@pytest.mark.parametrize("h,kv", [(2, 2), (4, 2), (4, 1)])
@pytest.mark.parametrize("s,window", [(1, 0), (97, 8), (1000, 0),
                                      (1000, 4096), (300, 1)])
def test_flash_kernel_equals_plain_version(cuda, dtype, d, h, kv, s, window):
    """MHA, GQA and MQA, head dims below, at and above a warp (120 is no
    multiple of 32; 256 needs > 48 KB of shared memory), ragged S, with
    and without a window: the kernel equals the plain version, in q's
    dtype, and counts one launch on its dtype's route (bfloat16: the
    wgmma kernel; float32: the CUDA-core kernel)."""
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
