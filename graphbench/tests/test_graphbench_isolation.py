"""Nothing the benchmark loads is JAX or the JAX package, and the plain
reference loads nothing of the program under test."""
import json
import subprocess
import sys

from smallbench import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

_LOAD_ALL = """
import json, sys
sys.path.insert(0, {root!r})
import graphbench
from graphbench import calibrate, checks, generator, harness, peaks, \\
    profiling, ranks, registry, run
from graphbench.reference import counts, graph, hashing, mining, sketches
reg = registry.Registry.load()
for cell in reg.bench["workloads"]:
    reg.job(reg.mix(cell["traffic"])["job"])
for entry in reg.bench["per_layer"]:
    reg.metric(entry["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_LOAD_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import graphbench.reference.mining, graphbench.reference.sketches
import graphbench.reference.graph, graphbench.reference.counts
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_nor_the_jax_package():
    names = _top_level_names(_LOAD_ALL)
    assert "repro_torch" in names       # the program under test is loaded
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _top_level_names(_LOAD_REFERENCE)
    assert not names & (FORBIDDEN | {"repro_torch"})
