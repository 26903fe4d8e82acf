"""The port stands alone and never falls back quietly.

* Importing ``repro_torch`` and every submodule loads neither ``jax`` nor
  the reference package ``repro`` (checked in a fresh interpreter).
* Entry points default to ``device="cuda"`` and raise without a GPU
  (those of the tenth slice too: generators, checkpoint restores, dedup,
  the ragged adaptive converter and the launcher's ``--restore``; of
  the eleventh: ``mine()``, the spawn helper, meshes and sharded
  restores; of the model path: the model, its cache, the converter and
  the server; and of the training path: ``train()``, its launcher, the
  train state and its converter).
* ``use_kernel=True`` with CPU tensors raises.
* A missing nvcc raises a build error instead of returning a fallback.
* ``chip_smoke.py`` fails without a GPU, and outside the checkout.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import engine as TE
from repro_torch.core import graph as TG
from repro_torch.engine import setexpr as TX
from repro_torch.kernels import (_build, flash_attention, fused_expr,
                                 mh_intersect, ops, program)

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""


def test_import_loads_neither_jax_nor_reference():
    """Every submodule imports without pulling in jax or repro."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count = int(out.stdout.split()[0])
    assert count >= 20, out.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    """Present the process as one without a CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    """session() (the exact one too), kronecker(), from_edge_array(),
    Graph.to() and the launcher (local clustering and the exact count
    included) raise."""
    g = TG.kronecker(6, 4, seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TE.session(g, "bf")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TE.session(g, None)
    with pytest.raises(RuntimeError, match="cuda"):
        TG.kronecker(6, 4, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        TG.from_edge_array(4, [[0, 1], [1, 2]])
    with pytest.raises(RuntimeError, match="cuda"):
        g.to("cuda")
    from repro_torch.launch import mine
    with pytest.raises(RuntimeError, match="cuda"):
        mine.main(["--scale", "6"])
    with pytest.raises(RuntimeError, match="cuda"):
        mine.main(["--scale", "6", "--algos", "localcluster", "--exact"])
    assert TE.session(g, "bf", device="cpu").plan.use_kernel is False


def test_tenth_slice_entry_points_need_a_gpu(no_cuda, tmp_path):
    """The generators, the checkpoint restore (store and stream), the
    ragged converter, dedup and the launcher's --restore raise without a
    GPU unless given device='cpu'; the adaptive Bloom and link prediction
    run where their graph lives (a CPU graph here)."""
    import numpy as np

    from repro_torch import convert
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core import adaptive
    from repro_torch.core.algorithms import linkpred
    from repro_torch.data import dedup
    from repro_torch.launch import stream as launcher
    from repro_torch.stream import DynamicGraph, StreamSession

    for call in (lambda: TG.barabasi_albert(50, 3, seed=1),
                 lambda: TG.random_bipartite_community(50, 2, 0.2, 0.01),
                 lambda: dedup.document_sketches([np.arange(9)], 4),
                 lambda: dedup.minhash_dedup([np.arange(9)], k=4),
                 lambda: convert.adaptive_from_numpy(
                     np.zeros((2, 2), np.uint32), [2, 2], 1, 0),
                 lambda: DynamicGraph.from_keys(3, np.array([1]),
                                                np.array([1, 1, 0]))):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    save_checkpoint(str(tmp_path / "t"), 1, {"x": np.ones(3)})
    with pytest.raises(RuntimeError, match="cuda"):
        restore_checkpoint(str(tmp_path / "t"), 1, {"x": np.ones(3)})
    assert restore_checkpoint(str(tmp_path / "t"), 1, {"x": np.ones(3)},
                              device="cpu")["x"].device.type == "cpu"
    st = StreamSession(DynamicGraph.from_edges(4, [[0, 1], [1, 2]],
                                               device="cpu"), "bf")
    st.save(str(tmp_path / "s"))
    with pytest.raises(RuntimeError, match="cuda"):
        StreamSession.restore(str(tmp_path / "s"))
    with pytest.raises(RuntimeError, match="cuda"):
        launcher.main(["--scale", "6", "--restore", "--checkpoint-dir",
                       str(tmp_path / "s")])
    g = TG.kronecker(6, 4, seed=1, device="cpu")
    sk = adaptive.build_adaptive_bloom(g, 0.5)
    assert sk.data.device.type == "cpu"
    assert float(adaptive.adaptive_triangle_count(g, sk)) > 0
    assert 0.0 <= linkpred.link_prediction_effectiveness(g) <= 1.0


def test_sharded_path_entry_points_need_a_gpu(no_cuda, tmp_path):
    """mine(), the spawn helper (which starts no process then), the host
    mesh and a restore whose sharding lies on a CUDA mesh raise without a
    GPU; a sharded plan with no mesh runs the local fold on the CPU."""
    import multiprocessing
    import types

    import numpy as np

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.distributed import sharding, spawn
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import mine

    g = TG.kronecker(6, 4, seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        mine.mine(g)
    with pytest.raises(RuntimeError, match="cuda"):
        mine.mine(g, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        spawn(print, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        launch_mesh.make_host_mesh()
    assert not multiprocessing.active_children()
    save_checkpoint(str(tmp_path), 1, {"x": np.ones(4)})
    cuda_mesh = types.SimpleNamespace(device_type="cuda",
                                      mesh_dim_names=("data",), shape=(1,))
    with pytest.raises(RuntimeError, match="cuda"):
        restore_checkpoint(str(tmp_path), 1, {"x": np.ones(4)}, {
            "x": sharding.NamedSharding(cuda_mesh, ("data",))},
            device="cpu")
    assert mine.mine(g, device="cpu")["devices"] == 1
    from repro_torch.core.algorithms.tc import triangle_count
    sess = TE.session(g, "bf", device="cpu", shard_edges=True)
    assert float(triangle_count(g, sess.sketch, plan=sess.plan)) > 0


def test_model_path_entry_points_need_a_gpu(no_cuda):
    """init_params, init_cache, the converter, BatchedServer and the serve
    launcher raise without a GPU unless given device='cpu'."""
    from repro_torch import configs, convert
    from repro_torch.launch import serve
    from repro_torch.models import init_cache, init_params, reduced

    cfg = reduced(configs.get("qwen3_8b"))
    for call in (lambda: init_params(cfg),
                 lambda: init_cache(cfg, 1, 8),
                 lambda: convert.model_params_from_numpy({}, cfg),
                 lambda: serve.BatchedServer(serve.ServeConfig()),
                 lambda: serve.main([])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert init_params(cfg, device="cpu").final_norm.device.type == "cpu"


def test_training_entry_points_need_a_gpu(no_cuda):
    """train(), the train launcher's main(), init_train_state and the
    train-state converter raise without a GPU unless given device='cpu';
    on the CPU the trained model decodes through make_decode_step."""
    from repro_torch import configs, convert
    from repro_torch.distributed.step import init_train_state
    from repro_torch.launch import train
    from repro_torch.models import reduced
    from repro_torch.optim import AdamW

    run = train.TrainRunConfig(arch="gemma_2b", steps=2, global_batch=2,
                               seq_len=8, d_model=32, layers=1)
    cfg = reduced(configs.get("qwen3_8b"))
    for call in (lambda: train.train(run),
                 lambda: train.main(["--steps", "2"]),
                 lambda: init_train_state(cfg, AdamW()),
                 lambda: convert.train_state_from_numpy({}, cfg)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    state, hist = train.train(run, device="cpu")
    assert [h["step"] for h in hist] == [0, 1]
    from repro_torch.distributed.step import make_decode_step
    from repro_torch.models import decode_step, init_cache

    model, tcfg = state["params"], train.build(run)[0]
    tokens = torch.tensor([[3], [5]])
    with torch.no_grad():
        got, _ = make_decode_step(tcfg)(model, init_cache(tcfg, 2, 4,
                                                          device="cpu"),
                                        tokens)
        want, _ = decode_step(model, init_cache(tcfg, 2, 4, device="cpu"),
                              tcfg, tokens)
    assert torch.equal(got, want)


def test_use_kernel_on_cpu_tensors_raises():
    """An explicit kernel request cannot run on CPU tensors."""
    g = TG.kronecker(6, 4, seed=1, device="cpu")
    sess = TE.session(g, "bf", device="cpu", use_kernel=True)
    assert sess.plan.degree_order is True
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA"):
        sess.edge_cardinalities()
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA"):
        sess.four_clique_count()
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA"):
        sess.five_clique_count()
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA"):
        sess.local_cluster([0, 1])
    ce = TX.compile_expr(TX.and_all(*TX.rows(2)), use_kernel=True)
    data = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ce.ones_rows(data, data)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """With no nvcc anywhere, the build raises KernelBuildError."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "CUDA_ROOTS", (str(tmp_path),))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build()
    with pytest.raises(_build.KernelBuildError):
        _build.load("fused_expr")
    assert not (tmp_path / "build").exists()


def test_build_command_and_library_names():
    """The build targets sm_90a and names libraries by source digest."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    path = _build.library_path("fused_expr")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("fused_expr-") and path.suffix == ".so"
    assert _build.BUILD_DIR.relative_to(ROOT).parts[0] == "build"
    assert (ROOT / "src/repro_torch/kernels/csrc/fused_expr.cu").exists()
    for name in ("fused_expr", "mh_intersect", "flash_attention",
                 "flash_attention_wgmma"):
        assert (ROOT / "src/repro_torch/kernels/csrc" /
                _build.SOURCES[name]).exists()
        assert _build.library_path(name).name.startswith(f"{name}-")


def test_wrappers_validate_inputs():
    """Dtype, width, arity and device mismatches raise before any launch."""
    p = program.and_program(2)
    data = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        fused_expr.fused_gather_popcount(data, torch.zeros((2, 2)), p)
    with pytest.raises(ValueError, match="width"):
        fused_expr.fused_gather_popcount(
            data, torch.zeros((2, 1), dtype=torch.int32), p)
    with pytest.raises(ValueError, match="leaves"):
        fused_expr.fused_rows_popcount([data], p)
    with pytest.raises(ValueError, match="shape"):
        fused_expr.fused_rows_popcount([data, data[:2]], p)


def test_minhash_wrappers_validate_inputs():
    """Dtype, rank, shape, device and sentinel range are checked before
    any launch, on every path."""
    a = torch.zeros((3, 4), dtype=torch.int32)
    bad = [(a.to(torch.int64), a, "int32"), (a[0], a[0], "int32"),
           (a, a[:2], "shape"), (a, a.to("meta"), "meta"),
           (a, a, "sentinel")]
    for name in ("mh_intersect_pairs", "khash_match_pairs"):
        for x, y, match in bad:
            sentinel = 2 ** 31 if match == "sentinel" else 5
            for fn in (getattr(mh_intersect, name), getattr(ops, name)):
                with pytest.raises(ValueError, match=match):
                    fn(x, y, sentinel)
            with pytest.raises(ValueError, match=match):
                getattr(ops, name)(x, y, sentinel, use_kernel=False)


def test_minhash_gather_wrappers_validate_inputs():
    """The gather forms check the matrix, the pairs, their devices and the
    sentinel before any launch, on every path."""
    data = torch.zeros((3, 4), dtype=torch.int32)
    pairs = torch.zeros((2, 2), dtype=torch.int32)
    bad = [(data, pairs.long(), "int32"), (data, pairs[:, :1], "E, 2"),
           (data[0], pairs, "int32"), (data, pairs.to("meta"), "meta"),
           (data, pairs, "sentinel")]
    before = dict(mh_intersect.LAUNCHES)
    for name in ("mh_intersect_gather", "khash_match_gather"):
        for x, y, match in bad:
            sentinel = 2 ** 31 if match == "sentinel" else 5
            for fn in (getattr(mh_intersect, name), getattr(ops, name)):
                with pytest.raises(ValueError, match=match):
                    fn(x, y, sentinel)
            with pytest.raises(ValueError, match=match):
                getattr(ops, name)(x, y, sentinel, use_kernel=False)
    assert mh_intersect.LAUNCHES == before


def test_cpu_path_counts_no_launches():
    """The plain CPU path leaves the kernels' launch counts alone."""
    before = dict(fused_expr.LAUNCHES)
    data = torch.arange(12, dtype=torch.int32).reshape(6, 2)
    tuples = torch.tensor([[0, 1], [2, 5]], dtype=torch.int32)
    p = program.and_program(2)
    fused_expr.fused_gather_popcount(data, tuples, p)
    fused_expr.fused_rows_popcount([data, data], p)
    fused_expr.fused_segment_popcount(data, tuples[:, :1], torch.tensor(
        [0, 1, 2]), tuples[:, 1].contiguous())
    assert fused_expr.LAUNCHES == before
    before_mh = dict(mh_intersect.LAUNCHES)
    forms = dict(fused_expr.FORM_LAUNCHES)
    mh_intersect.mh_intersect_pairs(data, data, 7)
    mh_intersect.khash_match_pairs(data, data, 7)
    ops.mh_intersect_pairs(data, data, 7)
    ops.khash_match_pairs(data, data, 7)
    mh_forms = dict(mh_intersect.FORM_LAUNCHES)
    for name in ("mh_intersect_gather", "khash_match_gather"):
        getattr(mh_intersect, name)(data, tuples, 7)
        getattr(ops, name)(data, tuples, 7)
    g = TG.kronecker(6, 4, seed=1, device="cpu")
    for kind in ("kh", "1h"):
        float(TE.session(g, kind, device="cpu", variant="naive")
              .triangle_count())
    assert mh_intersect.LAUNCHES == before_mh
    assert mh_intersect.FORM_LAUNCHES == mh_forms
    assert fused_expr.FORM_LAUNCHES == forms
    float(TE.session(g, "bf", device="cpu").five_clique_count())
    float(TE.session(g, "kh", device="cpu").four_clique_count())
    before_fa = dict(flash_attention.LAUNCHES)
    routes = dict(flash_attention.ROUTE_LAUNCHES)
    q = torch.zeros((1, 5, 2, 8))
    for x in (q, q.to(torch.bfloat16)):
        flash_attention.flash_attention(x, x, x)
        flash_attention.flash_attention_folded(x[0], x[0], x[0], groups=1)
    assert flash_attention.LAUNCHES == before_fa
    assert flash_attention.ROUTE_LAUNCHES == routes
    assert fused_expr.LAUNCHES == before
    assert mh_intersect.LAUNCHES == before_mh


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"},
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("script", ["segment_variants.py",
                                    "clique_passes.py",
                                    "minhash_variants.py",
                                    "minhash_passes.py",
                                    "attention_fp32.py"])
def test_gpu_scripts_fail_without_gpu(script):
    """The measurement scripts beside chip_smoke.py refuse to run without
    a GPU instead of timing the CPU, and print no result."""
    out = subprocess.run([sys.executable, script], cwd=ROOT,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "needs an NVIDIA GPU" in out.stderr
    assert out.stdout == ""


def test_chip_smoke_fails_without_gpu_and_alone(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line here (no
    CUDA), and likewise from a directory holding only itself."""
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _run_smoke(tmp_path)
    assert alone.returncode != 0
    assert '"ok": true' not in alone.stdout
