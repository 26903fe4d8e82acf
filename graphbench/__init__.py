"""The benchmark of ``repro_torch``, ProbGraph's PyTorch and CUDA port.

``python3 graphbench/run.py --workload <config>.<mix> --seed N --seconds S
--trace 0|1`` (or ``python3 -m graphbench.run ...``) runs one cell of
``BENCHMARK.json`` once on the GPU and prints one JSON result line. The
program under test is imported from the checkout's ``src/``, which this
package puts first on ``sys.path``.
"""
import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parent.parent / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
