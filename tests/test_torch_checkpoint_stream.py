"""Port parity: stream checkpoints and the stream launcher's flags.

* A stream saved by ``repro.stream`` after 2 deltas and restored by the
  port (``adj`` and ``headroom`` ignored, ROADMAP difference 13) gives the
  reference session's state and answers, and again after one more delta
  on both. A port save → restore → delta equals an uninterrupted port
  stream.
* ``launch.stream`` with ``--checkpoint-every 2`` stopped after 4 of 6
  batches (a crash: the 5th delta raises), then ``--restore``, ends where
  a straight 6-batch run ends; flags that would replay another stream
  (``--batches 4`` against a checkpoint of 6) are refused.

Sizes: Kronecker scale 8, streams of ≤ 3 deltas, launcher scale 6.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from repro.core import graph as RG
from repro.stream import ErrorBudgetPolicy as RPolicy
from repro.stream import stream_session as r_stream_session
from repro_torch.checkpoint import latest_step, load_meta
from repro_torch.core import graph as TG
from repro_torch.launch import stream as TL
from repro_torch.stream import (BatchedQueryServer, ErrorBudgetPolicy,
                                StreamSession, stream_session)

CPU = "cpu"
KW = dict(words=4, k=6, num_hashes=2, seed=3)


# ---------------------------------------------------------------------------
# stream checkpoints
# ---------------------------------------------------------------------------

def _deltas(seed, n, edges_fn, steps):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        cur = edges_fn()
        yield (rng.integers(0, n, size=(30, 2)),
               cur[rng.choice(cur.shape[0], 10, replace=False)])


def _assert_state_equal(r, t):
    """Reference (or port) session ``r`` against port session ``t``."""
    assert r.version == t.version and r.dyn.m == t.dyn.m
    assert np.array_equal(np.asarray(r.dyn.edge_keys), t.dyn.edge_keys)
    assert np.array_equal(np.asarray(r.dyn.deg), t.dyn.deg)
    if r.maintainer is None:
        assert t.maintainer is None
        return
    want = np.asarray(r.sketch.data)
    got = t.sketch.data.numpy()
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    assert np.array_equal(want, got)
    assert np.array_equal(r.maintainer.dirty, t.maintainer.dirty)
    assert np.array_equal(r.maintainer.stale, t.maintainer.stale)
    assert r.maintainer.stats() == t.maintainer.stats()


def _answers(st, pairs):
    return (float(st.triangle_count()),
            np.asarray(st.similarity(pairs, "jaccard")))


def _assert_answers_equal(r, t, pairs):
    """TC within ROADMAP difference 2's rtol, per-pair answers within the
    same bound (Bloom ``log1p``; MinHash identical)."""
    rt, rs = _answers(r, pairs)
    tt, ts = _answers(t, pairs)
    assert tt == pytest.approx(rt, rel=1e-6)
    np.testing.assert_allclose(ts, rs, rtol=1e-6, atol=1e-7)


def test_reference_stream_checkpoint_restored_by_the_port(tmp_path):
    """A ``repro.stream`` session (lax policy: dirty rows pending) saved
    after 2 deltas: the port restores it (its ``adj`` never read) with the
    reference session's state and answers, and both stay equal through
    one more delta."""
    rg = RG.kronecker(8, 6, seed=4)
    r = r_stream_session(rg, "bf", policy=RPolicy(50.0), **KW)
    for ins, dels in _deltas(1, rg.n, r.dyn.edge_array, 2):
        r.apply_delta(ins, dels)
    assert r.maintainer.dirty.any()
    path = r.save(str(tmp_path), extra={"run": "ref"})
    assert os.path.exists(os.path.join(path, "adj.npy"))
    t = StreamSession.restore(str(tmp_path), device=CPU)
    assert t.extra == {"run": "ref"}
    _assert_state_equal(r, t)
    pairs = np.random.default_rng(2).integers(0, rg.n, (24, 2)).astype(
        np.int32)
    _assert_answers_equal(r, t, pairs)
    ins = np.random.default_rng(3).integers(0, rg.n, (25, 2))
    dels = r.dyn.edge_array()[:7]
    ri, ti = r.apply_delta(ins, dels), t.apply_delta(ins, dels)
    assert {k: v for k, v in ri.items() if k != "bytes_uploaded"} == \
        {k: v for k, v in ti.items() if k != "bytes_uploaded"}
    _assert_state_equal(r, t)
    _assert_answers_equal(r, t, pairs)
    assert r.flush() == t.flush()
    _assert_state_equal(r, t)


@pytest.mark.parametrize("kind", ["bf", None])
def test_port_save_restore_delta_equals_uninterrupted_stream(tmp_path, kind):
    """save → restore → delta gives the uninterrupted stream's state,
    device CSR and answers bit for bit; a checkpoint holds no ``adj``."""
    g = TG.kronecker(8, 6, seed=4, device=CPU)
    kw = dict(KW, policy=ErrorBudgetPolicy(50.0)) if kind else {}
    live = stream_session(g, kind, **kw)
    steps = list(_deltas(5, g.n, live.dyn.edge_array, 1))
    live.apply_delta(*steps[0])
    live.session.edge_cardinalities()
    path = live.save(str(tmp_path))
    assert not os.path.exists(os.path.join(path, "adj.npy"))
    meta = load_meta(str(tmp_path), live.version)
    if kind == "bf":
        assert meta["leaves"]["sketch"]["dtype"] == "uint32"
    restored = StreamSession.restore(str(tmp_path), device=CPU)
    assert restored.serving_view().version == live.version
    restored.session.edge_cardinalities()
    rng = np.random.default_rng(6)
    ins, dels = rng.integers(0, g.n, (40, 2)), live.dyn.edge_array()[3:9]
    info_l, info_r = live.apply_delta(ins, dels), restored.apply_delta(ins,
                                                                       dels)
    assert info_l == info_r
    _assert_state_equal(live, restored)
    for f in ("indptr", "indices", "deg", "edges"):
        assert torch.equal(getattr(live.graph, f), getattr(restored.graph, f))
    pairs = rng.integers(0, g.n, (16, 2)).astype(np.int32)
    for a, b in zip(_answers(live, pairs), _answers(restored, pairs)):
        np.testing.assert_array_equal(a, b)
    srv_l, srv_r = BatchedQueryServer(live), BatchedQueryServer(restored)
    rid_l = srv_l.submit_triangle_count()
    rid_r = srv_r.submit_triangle_count()
    assert srv_l.flush()[rid_l].value == srv_r.flush()[rid_r].value
    srv_l.close()
    srv_r.close()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TL.main(argv)
    lines = buf.getvalue().strip().splitlines()
    return json.loads(lines[-1]), lines


BASE = ["--scale", "6", "--edge-factor", "8", "--device", CPU,
        "--batches", "6"]


def test_launcher_checkpoint_restore_equals_straight_run(tmp_path,
                                                          monkeypatch):
    """A 6-batch replay checkpointed every 2 batches and stopped by a
    crash in its 5th delta resumes from step 4 and ends where a straight
    6-batch run ends: the same batches' TC lines, final edges, version,
    maintenance counters and last TC."""
    straight, straight_lines = _run(BASE)
    ck = str(tmp_path / "ck")
    real = StreamSession.apply_delta
    calls = []

    def crash_on_fifth(self, *args, **kw):
        calls.append(1)
        if len(calls) == 5:
            raise RuntimeError("simulated crash")
        return real(self, *args, **kw)

    monkeypatch.setattr(StreamSession, "apply_delta", crash_on_fifth)
    with pytest.raises(RuntimeError, match="simulated crash"):
        _run(BASE + ["--checkpoint-dir", ck, "--checkpoint-every", "2"])
    monkeypatch.setattr(StreamSession, "apply_delta", real)
    assert latest_step(ck) == 4
    resumed, lines = _run(BASE + ["--checkpoint-dir", ck, "--restore"])
    assert any(line.startswith("restored: version=4") for line in lines)
    assert resumed["batches"] == 2 and straight["batches"] == 6
    for key in ("n", "final_m", "last_tc"):
        assert resumed[key] == straight[key], key
    for key in ("version", "n", "m", "maintenance"):
        assert resumed["stream"][key] == straight["stream"][key], key
    # the replayed batches print what the straight run printed for them
    tail = [line.split(" recomputed")[0] for line in straight_lines
            if line.startswith(("[004]", "[005]"))]
    assert [line.split(" recomputed")[0] for line in lines
            if line.startswith(("[004]", "[005]"))] == tail


def test_launcher_refuses_mismatched_flags(tmp_path):
    ck = str(tmp_path / "ck")
    out, _ = _run(BASE + ["--checkpoint-dir", ck, "--checkpoint-every", "3"])
    assert out["batches"] == 6 and latest_step(ck) == 6
    for flags in (["--batches", "4"], ["--seed", "2"], ["--kind", "kh"]):
        argv = BASE + ["--checkpoint-dir", ck, "--restore"] + flags
        with pytest.raises(SystemExit, match="does not match"):
            _run(argv)
    with pytest.raises(SystemExit, match="requires --checkpoint-dir"):
        _run(BASE + ["--restore"])
