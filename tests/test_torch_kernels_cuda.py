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
from repro_torch.kernels import fused_expr, program, ref

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
