"""The port stands alone and never falls back quietly.

* Importing ``repro_torch`` and every submodule loads neither ``jax`` nor
  the reference package ``repro`` (checked in a fresh interpreter).
* Entry points default to ``device="cuda"`` and raise without a GPU.
* ``use_kernel=True`` with CPU tensors raises.
* A missing nvcc raises a build error instead of returning a fallback.
* ``chip_smoke.py`` fails without a GPU, and outside the checkout.
"""
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
from repro_torch.kernels import _build, fused_expr, program

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
    """session(), kronecker(), from_edge_array() and Graph.to() raise."""
    g = TG.kronecker(6, 4, seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TE.session(g, "bf")
    with pytest.raises(RuntimeError, match="cuda"):
        TG.kronecker(6, 4, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        TG.from_edge_array(4, [[0, 1], [1, 2]])
    with pytest.raises(RuntimeError, match="cuda"):
        g.to("cuda")
    from repro_torch.launch import mine
    with pytest.raises(RuntimeError, match="cuda"):
        mine.main(["--scale", "6"])
    assert TE.session(g, "bf", device="cpu").plan.use_kernel is False


def test_use_kernel_on_cpu_tensors_raises():
    """An explicit kernel request cannot run on CPU tensors."""
    g = TG.kronecker(6, 4, seed=1, device="cpu")
    sess = TE.session(g, "bf", device="cpu", use_kernel=True)
    assert sess.plan.degree_order is True
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA"):
        sess.edge_cardinalities()
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


def test_cpu_path_counts_no_launches():
    """The plain CPU path leaves the kernels' launch counts alone."""
    before = dict(fused_expr.LAUNCHES)
    data = torch.arange(12, dtype=torch.int32).reshape(6, 2)
    tuples = torch.tensor([[0, 1], [2, 5]], dtype=torch.int32)
    p = program.and_program(2)
    fused_expr.fused_gather_popcount(data, tuples, p)
    fused_expr.fused_rows_popcount([data, data], p)
    assert fused_expr.LAUNCHES == before


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"},
                          capture_output=True, text=True, timeout=120)


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
