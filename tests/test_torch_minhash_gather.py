"""Port parity: the gather form of the MinHash counts.

``mh_intersect_gather`` / ``khash_match_gather`` take the sketch matrix
int32[n, k] and pairs int32[E, 2] and count rows ``data[u]``, ``data[v]``
as ``mh_intersect_pairs`` / ``khash_match_pairs`` count pre-gathered rows.
On the CPU every wrapper runs the plain version (``kernels/ref.py``:
``gather_rows``, then the rows count). Inputs are made with numpy from a
seed; counts are integers and must be identical to the reference's
Pallas kernels (``repro.kernels.mh_intersect`` in interpret mode) on the
same rows, gathered with numpy. The CUDA kernels themselves are held to
these plain versions on the card (``tests/test_torch_kernels_cuda.py``).
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mh_intersect as RMH
from repro_torch import engine as TE
from repro_torch.core import graph as TG
from repro_torch.kernels import mh_intersect as TMH
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR

NAMES = ("mh_intersect_pairs", "khash_match_pairs")
SENTINEL = 60


def _gather_name(name: str) -> str:
    return name.replace("_pairs", "_gather")


def _sketch(rng, n: int, k: int) -> np.ndarray:
    """int32[n, k] rows drawn from [-20, SENTINEL + 20): negative ids, pads
    above the sentinel, duplicates within rows; every 5th row all
    sentinel, and row 1 a copy of row 0 with half its entries replaced."""
    data = rng.integers(-20, SENTINEL + 20, size=(n, k)).astype(np.int32)
    data[1] = np.where(rng.random(k) < 0.5, data[0], data[1])
    data[::5] = SENTINEL
    return data


def _counts(rows_fn, data: np.ndarray, pairs: np.ndarray, name: str):
    """The reference's Pallas kernel (interpret mode, one block) on rows
    gathered by ``rows_fn(data, ids)``."""
    a = rows_fn(data, pairs[:, 0])
    b = rows_fn(data, pairs[:, 1])
    fn = getattr(RMH, name)
    return np.asarray(fn(jnp.asarray(a), jnp.asarray(b), SENTINEL,
                         block_e=a.shape[0], interpret=True))


def _port_counts(name: str, data: torch.Tensor, pairs: torch.Tensor):
    """Every CPU route of the gather form: the wrapper, ``ops`` (device
    dispatch and ``use_kernel=False``) and the plain version."""
    g = _gather_name(name)
    return [getattr(TMH, g)(data, pairs, SENTINEL),
            getattr(TO, g)(data, pairs, SENTINEL),
            getattr(TO, g)(data, pairs, SENTINEL, use_kernel=False),
            getattr(TR, g)(data, pairs, SENTINEL)]


@pytest.mark.parametrize("k", [1, 7, 28, 31, 33])
def test_gather_counts_identical_to_reference_kernels(k):
    """Both gather counts equal the reference's Pallas kernels on the same
    rows gathered with numpy, through every CPU route, with no launch
    counted; pairs include (u, u) and the copied row pair (0, 1)."""
    rng = np.random.default_rng(k)
    n, e = 97, 257
    data = _sketch(rng, n, k)
    pairs = rng.integers(0, n, size=(e, 2)).astype(np.int32)
    pairs[:3] = [[0, 1], [1, 0], [2, 2]]
    td, tp = torch.from_numpy(data), torch.from_numpy(pairs)
    before = dict(TMH.LAUNCHES), dict(TMH.FORM_LAUNCHES)
    for name in NAMES:
        want = _counts(lambda d, ids: d[ids], data, pairs, name)
        for got in _port_counts(name, td, tp):
            assert got.dtype == torch.int32 and got.shape == (e,)
            assert np.array_equal(got.numpy(), want)
        rows = getattr(TO, name)(td[tp[:, 0].long()], td[tp[:, 1].long()],
                                 SENTINEL)
        assert np.array_equal(rows.numpy(), want)
    assert (dict(TMH.LAUNCHES), dict(TMH.FORM_LAUNCHES)) == before


def test_gather_empty_views_and_zero_width():
    """E = 0 gives an empty count (the reference's padded ops raise there,
    reference fault 4); a matrix view whose base is shifted by one word
    and a pair view of every other row count like their copies; k = 0
    counts zero."""
    rng = np.random.default_rng(5)
    data = torch.from_numpy(_sketch(rng, 40, 31))
    pairs = torch.from_numpy(rng.integers(0, 40, size=(64, 2))
                             .astype(np.int32))
    buf = torch.empty(40 * 31 + 1, dtype=torch.int32)
    shifted = buf[1:].view(40, 31)
    shifted.copy_(data)
    for name in NAMES:
        g = _gather_name(name)
        for got in _port_counts(name, data, pairs[:0]):
            assert got.dtype == torch.int32 and got.shape == (0,)
        want = getattr(TR, g)(data, pairs.contiguous(), SENTINEL)
        assert torch.equal(getattr(TMH, g)(shifted, pairs, SENTINEL), want)
        assert torch.equal(getattr(TMH, g)(data, pairs[::2], SENTINEL),
                           want[::2])
        zero = getattr(TMH, g)(data[:, :0], pairs, SENTINEL)
        assert zero.tolist() == [0] * 64


def test_gather_ids_clamp_unlike_the_reference():
    """Ids outside [0, n) clamp to the nearest row, as every kernel of the
    port does (ROADMAP Queue 3, deliberate difference 1). The reference
    reads rows with ``jnp.take``: ids in [-n, 0) wrap, and ids beyond fill
    the row with INT32_MIN, a valid entry; in-range ids agree."""
    rng = np.random.default_rng(11)
    n, k = 23, 7
    data = _sketch(rng, n, k)
    data[n - 1] = np.arange(k)          # distinct entries: a k-count row
    ids = np.array([[-1, 3], [-n, 4], [n, n + 5], [2 ** 31 - 1, -2 ** 31],
                    [n - 1, 0], [5, 6]], dtype=np.int32)
    clamped = np.clip(ids, 0, n - 1)
    td, tp = torch.from_numpy(data), torch.from_numpy(ids)

    def take(d, i):
        return np.asarray(jnp.take(jnp.asarray(d), jnp.asarray(i), axis=0))

    assert (take(data, ids[2:3, 0]) == np.iinfo(np.int32).min).all()
    for name in NAMES:
        want = _counts(lambda d, i: d[i], data, clamped, name)
        reference = _counts(take, data, ids, name)
        for got in _port_counts(name, td, tp):
            assert np.array_equal(got.numpy(), want)
        assert np.array_equal(reference[4:], want[4:])
        # (n, n + 5): two INT32_MIN rows in the reference, row n - 1 twice
        # here; k² = 49 vs 7 matches for mh, k = 7 vs 7 for khash
        assert reference[2] == (k * k if name == "mh_intersect_pairs" else k)
        assert want[2] == k


def test_gather_rejects_bad_operands_before_any_launch():
    """Pair dtypes and shapes, matrix dtype and rank, mixed devices, a
    matrix with no rows and a sentinel outside int32 raise ValueError on
    every path, and nothing is counted."""
    data = torch.zeros((6, 4), dtype=torch.int32)
    pairs = torch.zeros((3, 2), dtype=torch.int32)
    bad = [(data, pairs.long(), 5, "int32"),
           (data, pairs.float(), 5, "int32"),
           (data, torch.zeros((3, 3), dtype=torch.int32), 5, r"\[E, 2\]"),
           (data, pairs[:, 0], 5, r"\[E, 2\]"),
           (data, pairs[None], 5, r"\[E, 2\]"),
           (data.long(), pairs, 5, "int32"),
           (data[0], pairs, 5, r"\[n, k\]"),
           (data, pairs.to("meta"), 5, "meta"),
           (data[:0], pairs, 5, "no rows"),
           (data, pairs, 2 ** 31, "sentinel"),
           (data, pairs, -2 ** 31 - 1, "sentinel")]
    before = dict(TMH.LAUNCHES), dict(TMH.FORM_LAUNCHES)
    for name in NAMES:
        g = _gather_name(name)
        for d, p, sentinel, match in bad:
            for fn in (getattr(TMH, g), getattr(TO, g)):
                with pytest.raises(ValueError, match=match):
                    fn(d, p, sentinel)
            with pytest.raises(ValueError, match=match):
                getattr(TO, g)(d, p, sentinel, use_kernel=False)
    assert (dict(TMH.LAUNCHES), dict(TMH.FORM_LAUNCHES)) == before


def test_gather_routing():
    """``use_kernel=True`` on CPU tensors raises; ``False`` runs the plain
    version; None follows the tensors' device (the plain version here)."""
    rng = np.random.default_rng(2)
    data = torch.from_numpy(_sketch(rng, 30, 9))
    pairs = torch.from_numpy(rng.integers(0, 30, size=(50, 2))
                             .astype(np.int32))
    for name in NAMES:
        g = _gather_name(name)
        with pytest.raises(ValueError, match="needs CUDA"):
            getattr(TO, g)(data, pairs, SENTINEL, use_kernel=True)
        want = getattr(TR, name)(data[pairs[:, 0].long()],
                                 data[pairs[:, 1].long()], SENTINEL)
        assert torch.equal(getattr(TO, g)(data, pairs, SENTINEL,
                                          use_kernel=False), want)
        assert torch.equal(getattr(TO, g)(data, pairs, SENTINEL), want)


#: float32 bit patterns of the TC of ``kronecker(9, 16, seed=1)`` at
#: storage budget 1.0 (k = 19), as the port computed it before the
#: gather form existed
TC_BITS = {"kh": 1188828981, "1h-naive": 1188931085}


@pytest.mark.parametrize("label", ["kh", "1h-naive"])
def test_session_kernel_route_bit_identical(label, monkeypatch):
    """A CPU session gives the same TC as before, bit for bit. Its kernel
    route (``use_kernel=True``: the gather count, then the estimate),
    with the gather count run by its plain version, gives per-edge
    estimates identical to the plain path's and launches nothing."""
    kind, kw = ("kh", {}) if label == "kh" else ("1h", {"variant": "naive"})
    g = TG.kronecker(9, 16, seed=1, device="cpu")
    sess = TE.session(g, kind, storage_budget=1.0, device="cpu", **kw)
    tc = float(sess.triangle_count())
    assert struct.unpack("<I", struct.pack("<f", tc))[0] == TC_BITS[label]
    calls = []
    for name in NAMES:
        g_name = _gather_name(name)
        plain = getattr(TO, g_name)

        def run(data, pairs, sentinel, *, use_kernel=None, _plain=plain,
                _name=g_name):
            assert use_kernel is True
            calls.append(_name)
            return _plain(data, pairs, sentinel, use_kernel=False)
        monkeypatch.setattr(TO, g_name, run)
    before = dict(TMH.LAUNCHES), dict(TMH.FORM_LAUNCHES)
    kernel = TE.MiningSession(g, sess.sketch, sess.plan.with_(
        use_kernel=True, degree_order=False))
    plain = TE.MiningSession(g, sess.sketch, sess.plan.with_(
        use_kernel=False, degree_order=False))
    assert torch.equal(kernel.edge_cardinalities(),
                       plain.edge_cardinalities())
    assert float(kernel.triangle_count()) == float(plain.triangle_count())
    want = "khash_match_gather" if kind == "kh" else "mh_intersect_gather"
    assert calls and set(calls) == {want}
    assert (dict(TMH.LAUNCHES), dict(TMH.FORM_LAUNCHES)) == before
