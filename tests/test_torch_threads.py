"""Cap torch's CPU threads in the port's tests when they run under xdist.

Every other ``tests/test_torch_*.py`` imports this module before anything
else. Under pytest-xdist (``PYTEST_XDIST_WORKER`` is set) each worker
gets ``os.cpu_count() // PYTEST_XDIST_WORKER_COUNT`` intra-op threads, at
least one, and ``OMP_NUM_THREADS`` is set to the same value so that the
processes a test spawns (the distributed ranks) inherit the cap. Without
the cap each of several workers runs one thread per core, and the many
small ops of the port's plain path then oversubscribe the cores by the
number of workers. Outside xdist nothing is changed.
"""
import os
import subprocess
import sys
from pathlib import Path

import torch


def worker_threads(environ=os.environ):
    """Threads per xdist worker, or None outside xdist."""
    if "PYTEST_XDIST_WORKER" not in environ:
        return None
    workers = int(environ["PYTEST_XDIST_WORKER_COUNT"])
    return max(1, (os.cpu_count() or 1) // workers)


THREADS = worker_threads()
if THREADS is not None:
    torch.set_num_threads(THREADS)
    os.environ["OMP_NUM_THREADS"] = str(THREADS)

_PROBE = """
import torch
before = torch.get_num_threads()
import test_torch_threads
import os
print(before, torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS"))
"""


def test_threads_capped_under_xdist_and_untouched_otherwise():
    """In this process the cap holds under xdist; a fresh interpreter
    with the xdist variables is capped, one without them keeps torch's
    default and gets no OMP_NUM_THREADS."""
    if THREADS is not None:
        assert torch.get_num_threads() == THREADS
        assert os.environ["OMP_NUM_THREADS"] == str(THREADS)
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("PYTEST_XDIST_") and k != "OMP_NUM_THREADS"}
    base["PYTHONPATH"] = str(Path(__file__).resolve().parent)
    runs = {}
    for label, extra in (("plain", {}),
                         ("xdist", {"PYTEST_XDIST_WORKER": "gw0",
                                    "PYTEST_XDIST_WORKER_COUNT": "6"})):
        out = subprocess.run([sys.executable, "-c", _PROBE],
                             env={**base, **extra}, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        runs[label] = out.stdout.split()
    before, after, omp = runs["plain"]
    assert after == before and omp == "None"
    cap = str(max(1, (os.cpu_count() or 1) // 6))
    assert runs["xdist"][1:] == [cap, cap]
