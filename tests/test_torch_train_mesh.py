"""Port parity, training over a mesh: one (2, 2) train step on 4 gloo
ranks against the JAX package's step jitted on a (2, 2) mesh of 4 host
devices; ``launch.train.train`` at ``mesh_shape`` (2, 2) against its
(1, 1) run; a checkpoint written under (2, 2) restored under (1, 1).

The reference's ``train`` cannot build its (2, 2) mesh (``jax.make_mesh``
gives Explicit axes, which its ``shard_as`` refuses: ROADMAP reference
fault 11). So the reference side is its ``make_train_step`` and the
gradient of its ``loss_fn``, jitted with ``train_state_shardings`` and
``batch_shardings`` on a hand-built ``Mesh`` of Auto axes, in a
subprocess that sets ``XLA_FLAGS`` first; its initial state is carried
into the port's ranks (``distributed.report.train_step_report``). The
``train()`` runs start from the port's own random weights, so there the
port's (1, 1) run is the anchor; each rank makes the same state and
batches from the seed and keeps its shards; its step runs on DTensors.
Options the reference's ``train`` lacks (the expert-parallel layer, one
kv head) come in through ``build``, patched in each rank's process.

Tolerances (float32, reduced configs):
* against the reference (one step of AdamW at lr 1.5e-3, step 1 of
  ``cosine_warmup(3e-3, 2, 10)``): loss and ``grad_norm`` rtol 1e-5;
  gradients within 1e-5 · max |reference| per leaf; parameters within
  0.1 · lr everywhere and within 1e-3 · lr on all but 1e-3 of each leaf,
  as ``test_torch_train_step.py`` holds the one-device step (AdamW's
  first update lr · g / (|g| + 1e-8) turns a gradient near 1e-8 and its
  float32 rounding into a visible step);
* ``train()`` (2 steps of AdamW at lr 3e-3): losses rtol 1e-5 (observed
  <= 2e-7: the sharded sums run in another order); parameters within
  0.1 · lr (observed <= 0.03 · lr). The expert-parallel run uses
  capacity factor 2 = E / k, so no assignment is dropped and the
  per-shard capacity agrees with the whole batch's.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import dataclasses

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.distributed import spawn
from repro_torch.distributed import step as STEP
from repro_torch.distributed.report import train_step_report
from repro_torch.launch import train as TR
from repro_torch.launch.mesh import fake_group
from repro_torch.launch.train import TrainRunConfig, build, train, \
    train_rank
from repro_torch.models import reduced

LR = 3e-3
RUN = TrainRunConfig(arch="qwen3_8b", steps=2, global_batch=4, seq_len=32,
                     d_model=64, layers=2, lr=LR, warmup=1)


_REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import dataclasses
import jax, numpy as np
from jax.sharding import Mesh
from repro import configs as RC
from repro import optim as RO
from repro.distributed import sharding as SH
from repro.distributed import step as STEP
from repro.models import ShapeConfig, loss_fn, reduced
with open(sys.argv[2], "rb") as f:
    cases = pickle.load(f)
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out = []
for c in cases:
    cfg = dataclasses.replace(reduced(RC.get(c["arch"]), **c["reduced"]),
                              **c["fields"])
    opt = RO.AdamW(learning_rate=RO.cosine_warmup(*c["schedule"]),
                   keep_master=False)
    state = STEP.init_train_state(cfg, opt, jax.random.PRNGKey(0))
    start = jax.tree.map(np.asarray, state)
    batch = c["batch"]
    b, s = batch["labels"].shape
    with SH.use_rules(mesh):
        s_sh = STEP.train_state_shardings(cfg, opt, mesh)
        b_sh = STEP.batch_shardings(cfg, ShapeConfig("t", s, b, "train"),
                                    mesh)
        b_sh = {k: b_sh[k] for k in batch}
        grad = jax.jit(jax.value_and_grad(lambda p, x: loss_fn(p, cfg, x)),
                       in_shardings=(s_sh["params"], b_sh),
                       out_shardings=(None, s_sh["params"]))
        loss, grads = grad(state["params"], batch)
        step = jax.jit(STEP.make_train_step(cfg, opt),
                       in_shardings=(s_sh, b_sh), out_shardings=(s_sh, None))
        state, metrics = step(state, batch)
    out.append({"start": start, "loss": float(loss),
                "grads": jax.tree.map(np.asarray, grads),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "params": jax.tree.map(np.asarray, state["params"])})
with open(sys.argv[3], "wb") as f:
    pickle.dump(out, f)
"""

#: the anchor's cases: reduced ``qwen3_8b`` and expert-parallel
#: ``phi35_moe`` (its default capacity, so drops happen per data shard)
ANCHORS = (("qwen3_8b", {}), ("phi35_moe", {"moe_impl": "ep"}))
SCHEDULE = (3e-3, 2, 10)          # lr 1.5e-3 at step 0
REDUCED = dict(layers=2, d_model=64, heads=4, ff=256)


def _agree(got, want, what, loose, tight, frac):
    """|got - want| <= loose everywhere and <= tight on all but ``frac``
    of the elements."""
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert diff.shape == np.shape(want), what
    assert diff.max() <= loose and (diff > tight).mean() <= frac, (
        what, diff.max(), (diff > tight).mean())


def test_mesh_step_matches_reference_on_its_mesh(tmp_path):
    """The reference's initial state carried into 4 gloo ranks, one step
    on the same batch, both sides on a (2, 2) mesh: loss, ``grad_norm``,
    every gradient and every parameter after the step."""
    rng = np.random.default_rng(5)
    cases = [{"arch": arch, "reduced": REDUCED, "schedule": SCHEDULE,
              "fields": {"dtype": "float32", "vocab_size": 512, **fields},
              "batch": {k: rng.integers(0, 512, (4, 32)).astype(np.int32)
                        for k in ("inputs", "labels")}}
             for arch, fields in ANCHORS]
    with open(tmp_path / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, src, str(tmp_path / "cases.pkl"),
         str(tmp_path / "out.pkl")], capture_output=True, text=True,
        timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / "out.pkl", "rb") as f:
        refs = pickle.load(f)
    port_cases = [{
        "mesh": ((2, 2), ("data", "model")), "schedule": SCHEDULE,
        "cfg": dataclasses.replace(reduced(TC.get(c["arch"]), **REDUCED),
                                   **c["fields"]),
        "state": r["start"], "batch": c["batch"]}
        for c, r in zip(cases, refs)]
    ranks = spawn(train_step_report, 4, args=(port_cases, "cpu"),
                  device="cpu", timeout_s=120)
    lr = SCHEDULE[0] / SCHEDULE[1]
    for i, ((arch, _), pc, ref) in enumerate(zip(ANCHORS, port_cases,
                                                  refs)):
        cfg = pc["cfg"]
        grads = convert.port_leaves(ref["grads"], cfg)
        params = convert.port_leaves(ref["params"], cfg)
        for rank in ranks:
            got = rank[i]
            np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(got["metrics"][key],
                                           ref["metrics"][key], rtol=1e-5)
            assert set(got["grads"]) == set(grads)
            for name, g in got["grads"].items():
                tol = 1e-5 * np.abs(grads[name]).max()
                _agree(g, grads[name], (arch, "grad", name), tol, tol, 0)
            for name, p in got["params"].items():
                _agree(p, params[name], (arch, "param", name), 0.1 * lr,
                       1e-3 * lr, 1e-3)
        assert any("S(" in pl for placements in
                   ranks[0][i]["placements"].values()
                   for pl in placements), "the state is sharded"


def _built_with(fields):
    """``launch.train.build`` with ``fields`` of the model config
    replaced: options the reference's ``train`` does not take."""
    def build_with(run):
        cfg, opt, data = build(run)
        return dataclasses.replace(cfg, **fields), opt, data
    return build_with


def _train_rank_with(run, fields):
    """A rank entry: ``train_rank`` on the CPU with ``build`` patched in
    this rank's own process (:func:`_built_with`)."""
    TR.build = _built_with(fields)
    return train_rank(run, "cpu")


def _one(run, **kw):
    state, hist = train(run, device="cpu", **kw)
    return {n: p.detach().clone() for n, p in
            state["params"].named_parameters()}, hist


def _compare(rank, params, hist):
    got = [h["loss"] for h in rank["history"]]
    np.testing.assert_allclose(got, [h["loss"] for h in hist], rtol=1e-5)
    for name, (_, full) in rank["params"].items():
        err = float((full - params[name]).abs().max())
        assert err <= 0.1 * LR, (name, err)


def test_mesh_run_equals_single_process_run(tmp_path):
    """Losses and parameters of the (2, 2) run equal the (1, 1) run's;
    every parameter is a DTensor laid out by
    ``train_state_shardings``; the (2, 2) run's checkpoint restores under
    (1, 1) to its gathered parameters."""
    ckpt = str(tmp_path / "ckpt")
    ranks = spawn(train_rank, 4, args=(dataclasses.replace(
        RUN, mesh_shape=(2, 2), ckpt_dir=ckpt), "cpu"), device="cpu",
        timeout_s=120)
    params, hist = _one(RUN)
    for rank in ranks:
        _compare(rank, params, hist)
    cfg, opt, _ = build(RUN)
    with fake_group(4):
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(2, 2, device="cpu")
        want = STEP.train_state_shardings(cfg, opt, mesh)["params"]
        for name, (placements, _) in ranks[0]["params"].items():
            assert placements == tuple(str(p) for p in
                                       want[name].placements), name
    # the checkpoint holds whole tensors: a (1, 1) run restores the last
    # step and has nothing left to train
    state, rest = train(dataclasses.replace(RUN, ckpt_dir=ckpt),
                        device="cpu")
    assert rest == []
    for name, p in state["params"].named_parameters():
        assert not hasattr(p, "placements")
        torch.testing.assert_close(p.detach(), ranks[0]["params"][name][1],
                                   rtol=0, atol=0)


def test_expert_parallel_mesh_run_equals_single_process_run(monkeypatch):
    """Reduced ``phi35_moe`` with ``moe_impl="ep"`` on (2, 2): the
    expert-parallel layer's run equals the (1, 1) run, where
    ``moe_fwd_ep`` is ``moe_fwd``."""
    run = dataclasses.replace(RUN, arch="phi35_moe")
    over = {"moe_impl": "ep", "capacity_factor": 2.0}
    ranks = spawn(_train_rank_with, 4, args=(dataclasses.replace(
        run, mesh_shape=(2, 2)), over), device="cpu", timeout_s=120)
    monkeypatch.setattr(TR, "build", _built_with(over))
    params, hist = _one(run)
    for rank in ranks:
        _compare(rank, params, hist)
    assert all(pl[1] == "S(0)" for name, (pl, _) in
               ranks[0]["params"].items() if name.endswith("ffn.wi_gate")), \
        "the experts are split over 'model'"


@pytest.mark.parametrize("arch", ["mamba2_130m"])
def test_ssm_mesh_run_equals_single_process_run(arch):
    """An SSM model's (2, 2) run (its scan split by heads over "model")
    equals its (1, 1) run."""
    run = dataclasses.replace(RUN, arch=arch)
    ranks = spawn(train_rank, 4, args=(dataclasses.replace(
        run, mesh_shape=(2, 2)), "cpu"), device="cpu", timeout_s=120)
    params, hist = _one(run)
    for rank in ranks:
        _compare(rank, params, hist)


def test_kv_heads_gathered_mesh_run_equals_single_process_run(monkeypatch):
    """One kv head for four query heads: the query heads split over
    "model", the kv head gathered, each rank's kv gradient partial; the
    (2, 2) run equals the (1, 1) run."""
    over = {"num_kv_heads": 1}
    ranks = spawn(_train_rank_with, 4, args=(dataclasses.replace(
        RUN, mesh_shape=(2, 2)), over), device="cpu", timeout_s=120)
    monkeypatch.setattr(TR, "build", _built_with(over))
    params, hist = _one(RUN)
    for rank in ranks:
        _compare(rank, params, hist)


def test_remat_recomputes_under_the_forward_rules():
    """The backward recomputes each layer (remat) on the thread that runs
    it, which on CUDA is autograd's own: the recompute must see the
    forward's mesh and rules. Reduced expert-parallel ``phi35_moe`` on a
    fake (2, 2) group, its backward run from another thread: the
    recomputed layers keep the forward's shapes (no checkpoint metadata
    mismatch) and every parameter gets a gradient."""
    import threading

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ShapeConfig, loss_fn, reduced
    from repro_torch.optim import AdamW

    cfg = dataclasses.replace(reduced(configs.get("phi35_moe")),
                              dtype="float32", moe_impl="ep")
    opt = AdamW()
    with fake_group(4):
        mesh = make_host_mesh(2, 2, device="cpu")
        with SH.use_rules(mesh), SH.model_context():
            sh = STEP.train_state_shardings(cfg, opt, mesh)
            model = STEP.init_sharded_train_state(cfg, opt, sh,
                                                  device="cpu")["params"]
            b_sh = STEP.batch_shardings(cfg, ShapeConfig("t", 32, 4,
                                                         "train"), mesh)
            batch = {k: STEP.sharded_tensor(
                b_sh[k], (4, 32), torch.int32, "cpu",
                lambda d, dtype, device: torch.randint(
                    0, cfg.vocab_size, d, dtype=dtype))
                for k in ("inputs", "labels")}
            loss = loss_fn(model, cfg, batch)
            errors = []

            def backward():   # as autograd's thread: no rules, and
                try:          # DTensor's implicit replication carried over
                    with implicit_replication():
                        loss.backward()
                except Exception as e:  # noqa: BLE001 - asserted below
                    errors.append(e)

            worker = threading.Thread(target=backward)
            worker.start()
            worker.join()
    assert not errors, errors
    assert all(p.grad is not None for p in model.parameters())
