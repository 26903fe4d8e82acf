"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Each source under ``csrc/`` becomes a shared library with a plain C
interface, compiled for ``sm_90a`` into ``build/repro_torch_kernels/`` at
the root of the checkout. A library's file name carries a digest of its
source and flags, so an edited source is rebuilt and a current one is
reused. Several sources build in parallel, one nvcc each. A missing nvcc
or a failed build raises :class:`KernelBuildError`: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_CSRC = Path(__file__).resolve().parent / "csrc"
#: the checkout's build/ directory (git ignores it)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

#: kernel library name -> source file under csrc/
SOURCES = {"fused_expr": "fused_expr.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: toolkit roots searched after $CUDA_HOME, $CUDA_PATH and $PATH
CUDA_ROOTS = ("/usr/local/cuda",)

_LOADED: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or a kernel source failed to compile."""


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/$CUDA_PATH, then $PATH, then CUDA_ROOTS."""
    roots = [os.environ.get(v) for v in ("CUDA_HOME", "CUDA_PATH")]
    for root in roots:
        if root and os.access(Path(root, "bin", "nvcc"), os.X_OK):
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    for root in CUDA_ROOTS:
        if os.access(Path(root, "bin", "nvcc"), os.X_OK):
            return str(Path(root, "bin", "nvcc"))
    raise KernelBuildError(
        "nvcc not found ($CUDA_HOME, $CUDA_PATH, $PATH, "
        f"{', '.join(CUDA_ROOTS)}): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library for ``name`` lives once built."""
    src = _CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every named library that is not built yet, all at once.

    Returns name -> library path. nvcc's output (``-Xptxas -v``: registers,
    spills) is kept beside each library as ``<name>.log``.
    """
    targets = {name: library_path(name) for name in names}
    todo = {name: path for name, path in targets.items() if not path.exists()}
    if not todo:
        return targets
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failed:
        raise KernelBuildError("kernel build failed: " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build([name])[name]))
    return lib
