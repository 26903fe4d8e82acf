"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA GPU and nvcc and skip without them (the check is
made inside the ``cuda`` fixture, never at import). This file imports
neither jax nor the reference package, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_kernels_cuda.py

Popcounts are integers: kernel and plain version must be equal.
"""
import pytest
import torch

from repro_torch import engine as TE
from repro_torch.core import graph as TG
from repro_torch.engine import setexpr
from repro_torch.kernels import fused_expr, mh_intersect, ops, program, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The CUDA device; skips the test when there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _programs():
    u, v, w, x = setexpr.rows(4)
    return [setexpr.compile_program(e) for e in
            (u & v, u & v & w, u & v & w & x, u | v, (u & v) - w,
             (u | (v & w)) - (x | u), setexpr.Row(3) & setexpr.Row(1))]


@pytest.mark.parametrize("w", [1, 2, 8, 32, 34, 600])
@pytest.mark.parametrize("t", [1, 33, 4099])
def test_kernels_equal_plain_versions(cuda, w, t):
    """Both forms, every program, ragged T, widths below and above a warp."""
    gen = torch.Generator(device=cuda).manual_seed(w * 10007 + t)
    data = torch.randint(-2**31, 2**31 - 1, (997, w), dtype=torch.int32,
                         device=cuda, generator=gen)
    tuples = torch.randint(0, 997, (t, 4), dtype=torch.int32, device=cuda,
                           generator=gen)
    for prog in _programs():
        before = dict(fused_expr.LAUNCHES)
        got = fused_expr.fused_gather_popcount(data, tuples, prog)
        rows = [data[tuples[:, s].long()] for s in prog.slots]
        got_r = fused_expr.fused_rows_popcount(rows, prog)
        assert torch.equal(got, ref.fused_gather_popcount(data, tuples, prog))
        assert torch.equal(got_r, ref.fused_rows_popcount(rows, prog))
        assert torch.equal(got, got_r)
        assert fused_expr.LAUNCHES["fused_gather_popcount"] == \
            before["fused_gather_popcount"] + 1
        assert fused_expr.LAUNCHES["fused_rows_popcount"] == \
            before["fused_rows_popcount"] + 1


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


@pytest.mark.parametrize("k", [1, 4, 7, 31, 33, 128, 256])
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
    assert mh_intersect.LAUNCHES == before
