"""Port parity, the sharded mining path: the sharding rules, the vertex-
and edge-sharded Bloom TC (``launch/mine.py``), the engine's
``shard_edges=True`` fold and the sharded checkpoint restore, on 2 and 4
gloo ranks spawned on the CPU.

The ranks run ``repro_torch.distributed.report.rank_report`` on
``kronecker(10, 16, seed=1)``, once on a (data, model) = (2, 1) mesh and
once on (2, 2). The JAX package runs in this process on its one CPU
device: its mesh-sharded fold fails under ``shard_map`` (reference fault
2), so the port's sharded fold is held against its local fold. Tolerances:

  * identical: spec tuples, sketch rows, restored shards and tensors;
  * ``rtol=1e-5`` (the reference's own, ``tests/test_engine.py``): TC
    estimates, whose float32 sums run in another order (the port folds
    each rank's block in chunks, then all-reduces the partials).
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import json
import multiprocessing
import operator
import time

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro import engine as RE
from repro.checkpoint import store as RC
from repro.core import graph as RG
from repro.core import sketches as RS
from repro.core.algorithms import tc as RT
from repro.distributed import sharding as RSH
from repro.launch import mine as RM
from repro_torch.distributed import sharding as TSH
from repro_torch.distributed import spawn
from repro_torch.distributed.report import rank_report
from repro_torch.launch import mine as TM

SCALE, EDGE_FACTOR, CHUNK, STEP = 10, 16, 1000, 3
MESHES = {2: (2, 1), 4: (2, 2)}
#: the checkpoint the reference saves: a 2-D split, a vocab split, an
#: edge list over every mesh dim, a replicated vector and a dim no mesh
#: dim divides
TREE = {"w": np.arange(48, dtype=np.float32).reshape(8, 6),
        "emb": np.arange(40, dtype=np.float32).reshape(10, 4) / 7,
        "e": np.arange(40, dtype=np.int32).reshape(20, 2),
        "b": np.ones(6, np.float32),
        "odd": np.arange(15, dtype=np.float32).reshape(5, 3)}
AXES = {"w": ("embed_fsdp", "ff"), "emb": ("vocab", "embed"),
        "e": ("edge", None), "b": (None,), "odd": ("embed_fsdp", None)}


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's results on one device, and its checkpoint."""
    g = RG.kronecker(SCALE, EDGE_FACTOR, seed=1)
    assert g.m % CHUNK != 0
    words = RS.bloom_words_for_budget(g.n, g.m, 0.25)
    mesh = jax.make_mesh((1,), ("data",))
    sk = RS.build(g, "bf", storage_budget=0.25)
    tc = {d: float(RT.triangle_count(g, sk, plan=RE.plan_for(
        g, sk, use_kernel=False, edge_chunk=CHUNK, degree_order=d)))
        for d in (False, True)}
    directory = str(tmp_path_factory.mktemp("ckpt"))
    RC.save_checkpoint(directory, STEP, TREE)
    restored = RC.restore_checkpoint(directory, STEP, TREE)
    return {"rows": np.asarray(RM.build_sketches_distributed(
                g, mesh, words, 2, 0)),
            "mine": RM.mine(g), "tc": tc, "dir": directory,
            "restored": {k: np.asarray(v) for k, v in restored.items()}}


@pytest.fixture(scope="module")
def ranks(reference):
    """Each rank's report, for 2 and 4 spawned ranks (one spawn each)."""
    ckpt = (reference["dir"], STEP, TREE, AXES)
    return {r: spawn(rank_report, r, (SCALE, EDGE_FACTOR, shape, "cpu",
                                      CHUNK, ckpt), device="cpu",
                     deadline_s=300)
            for r, shape in MESHES.items()}


def test_specs_and_tree_shardings_equal_reference():
    """spec_for on the reference's _FakeMesh cases and on the edge rule over
    three meshes (with and without dim sizes), and sharding_for_tree over
    a (2, 2) mesh, give the reference's spec tuples; placements follow."""
    from torch.distributed.tensor import Replicate, Shard

    cases = [({"data": 16, "model": 16}, ("batch", "seq", "vocab"),
              (1, 1, 32000)),
             ({"data": 16, "model": 16}, ("batch", "seq", "vocab"),
              (256, 4096, 50280)),
             ({"data": 16, "model": 16}, ("embed_fsdp", "heads",
                                          "head_dim_tp"), (4096, 32, 128)),
             ({"data": 16, "model": 16}, ("embed_fsdp", "heads",
                                          "head_dim_tp"), (2048, 8, 256))]
    for shape in ({"data": 4}, {"data": 2, "model": 2},
                  {"pod": 2, "data": 2, "model": 2}):
        cases += [(shape, ("edge", None), None), (shape, ("edge", None),
                                                  (12, 2))]
    for shape, axes, dims in cases:
        want = RSH.spec_for(axes, dims, mesh=_FakeMesh(shape),
                            rules=RSH.BASE_RULES)
        got = TSH.spec_for(axes, dims, mesh=_FakeMesh(shape),
                           rules=TSH.BASE_RULES)
        assert got == tuple(want), (shape, axes, dims)
    assert TSH.spec_for(("edge", None), mesh=_FakeMesh(
        {"pod": 2, "data": 2, "model": 2})) == (("pod", "data", "model"), None)
    with TSH.use_rules(_FakeMesh({"data": 2}), {"edge": "model"}):
        assert TSH.spec_for(("edge", None)) == (None, None)
    assert TSH.active_mesh() is None
    fake = _FakeMesh({"data": 2, "model": 2})
    got = TSH.sharding_for_tree(AXES, TREE, fake)
    want = RSH.sharding_for_tree(AXES, TREE, AbstractMesh((2, 2),
                                                          ("data", "model")))
    assert {k: v.spec for k, v in got.items()} == \
        {k: tuple(v.spec) for k, v in want.items()}
    assert got["w"].placements == [Shard(0), Shard(1)]
    assert got["e"].placements == [Shard(0), Shard(0)]
    assert got["b"].placements == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="order"):
        TSH.NamedSharding(fake, (("model", "data"),)).placements


def test_sketch_rows_identical_to_reference(ranks, reference):
    """build_sketches_distributed on 2 and 4 ranks: every rank holds the
    reference's rows, bit for bit."""
    for reports in ranks.values():
        for rep in reports:
            assert np.array_equal(rep["rows"].view(np.uint32),
                                  reference["rows"])


def test_mine_matches_reference(ranks, reference):
    """mine() on 2 and 4 ranks matches the reference's one-device mine()."""
    want = reference["mine"]
    for r, reports in ranks.items():
        for rep in reports:
            got = rep["mine"]
            assert got["words"] == want["words"] and got["devices"] == r
            np.testing.assert_allclose(got["tc_estimate"],
                                       want["tc_estimate"], rtol=1e-5)


def test_sharded_fold_matches_reference_local_fold(ranks, reference):
    """shard_edges=True under use_rules on 2 and 4 ranks, with
    degree_order off and on and an edge_chunk that does not divide m,
    matches the reference's local fold; every rank gets the same sum."""
    for reports in ranks.values():
        for d in (False, True):
            values = {rep["tc"][d] for rep in reports}
            assert len(values) == 1
            np.testing.assert_allclose(values.pop(), reference["tc"][d],
                                       rtol=1e-5)


def test_sharded_restore_of_a_reference_checkpoint(ranks, reference):
    """restore_checkpoint(shardings=) on a (2, 2) mesh: specs are the
    reference's, each rank's local shard is its numpy slice and
    full_tensor() is the reference's restore."""
    sizes = {"data": 2, "model": 2}
    for rep in ranks[4]:
        coord = dict(zip(("data", "model"), rep["coordinate"]))
        for key, leaf in rep["restore"].items():
            want = reference["restored"][key]
            assert np.array_equal(leaf["full"], want)
            index = []
            for dim, entry in enumerate(leaf["spec"]):
                axes = TSH.spec_axes(entry)
                parts = int(np.prod([sizes[a] for a in axes]))
                i = 0
                for a in axes:
                    i = i * sizes[a] + coord[a]
                block = want.shape[dim] // parts
                index.append(slice(i * block, (i + 1) * block))
            assert np.array_equal(leaf["local"], want[tuple(index)]), key
    specs = {k: leaf["spec"] for k, leaf in ranks[4][0]["restore"].items()}
    assert specs["e"] == (("data", "model"), None)
    assert specs["odd"] == (None, None)


def test_launcher_devices(capsys):
    """--devices 2 --device cpu prints the reference's estimate (rank 0
    only); --devices 2 --device cuda raises here."""
    TM.main(["--scale", "8", "--devices", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert lines[0].startswith("graph: n=256") and rec["event"] == "mine"
    assert rec["devices"] == 2 and len(lines) == 3
    want = RM.mine(RG.kronecker(8, 16, seed=1))["tc_estimate"]
    assert lines[1].startswith(f"TC_AND={want:.0f} ")
    np.testing.assert_allclose(rec["tc_estimate"], want, rtol=1e-5)
    with pytest.raises(RuntimeError, match="cuda"):
        TM.main(["--scale", "8", "--devices", "2", "--device", "cuda"])


def test_launcher_joins_the_torchrun_group(monkeypatch, capsys):
    """Under torchrun's environment (WORLD_SIZE, RANK, MASTER_ADDR,
    MASTER_PORT; world size 1 on gloo) main joins that group, mines inside
    it, prints one mine line with devices 1 and the reference's estimate,
    and leaves no group behind."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for key, value in {"WORLD_SIZE": "1", "RANK": "0",
                       "MASTER_ADDR": "localhost",
                       "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(key, value)
    seen = []
    mine = TM.mine

    def spy(*args, **kw):
        seen.append((dist.is_initialized() and dist.get_world_size(),
                     dist.is_initialized() and dist.get_backend()))
        return mine(*args, **kw)

    monkeypatch.setattr(TM, "mine", spy)
    TM.main(["--scale", "8", "--device", "cpu"])
    assert seen == [(1, "gloo")] and not dist.is_initialized()
    lines = capsys.readouterr().out.strip().splitlines()
    recs = [json.loads(x) for x in lines if x.startswith("{")]
    assert len(recs) == 1 and recs[0]["event"] == "mine"
    assert recs[0]["devices"] == 1
    want = RM.mine(RG.kronecker(8, 16, seed=1))["tc_estimate"]
    np.testing.assert_allclose(recs[0]["tc_estimate"], want, rtol=1e-5)


def test_spawn_fails_on_a_rank_that_raises_or_hangs():
    """A rank that raises fails the caller; ranks still running at the
    deadline are killed and the caller gets TimeoutError. No process is
    left behind."""
    with pytest.raises(Exception, match="ZeroDivisionError"):
        spawn(operator.truediv, 2, (1, 0), device="cpu", deadline_s=120)
    assert not multiprocessing.active_children()
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn(time.sleep, 2, (600,), device="cpu", deadline_s=8)
    assert time.monotonic() - t0 < 60
    assert not multiprocessing.active_children()
