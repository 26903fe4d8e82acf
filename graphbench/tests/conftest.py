"""Fixtures of the benchmark's CPU tests: a small copy of each cell.

``small`` gives a :class:`~graphbench.registry.Registry` whose extra root
(a temporary folder) holds the shipped configurations at scale 8 and the
shipped mixes tracing job 0 and checking the jobs right after it, and whose ``BENCHMARK.json``
copy has one cell ``small_<config>.<mix>`` per shipped cell.
"""
import copy
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from graphbench.registry import Registry  # noqa: E402

SCALE = 8


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def small_registry(root: Path, scale: int = SCALE) -> Registry:
    """The shipped benchmark with every cell also at ``scale``, its parts
    written under ``root``."""
    shipped = Registry.load()
    bench = copy.deepcopy(shipped.bench)
    (root / "configs").mkdir(exist_ok=True)
    (root / "mixes").mkdir(exist_ok=True)
    for entry in shipped.bench["configs"]:
        cfg = shipped.config(entry["name"])
        cfg["name"] = "small_" + entry["name"]
        cfg["scale"] = scale
        (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    for cell in shipped.bench["workloads"]:
        mix = shipped.mix(cell["traffic"])
        mix["traced_jobs"] = [0, 1]
        mix["sample_below"] = 1 + mix["checked_jobs"]
        (root / "mixes" / f"{cell['traffic']}.json").write_text(
            json.dumps(mix))
        small = dict(cell, name="small_" + cell["name"],
                     config="small_" + cell["config"])
        bench["workloads"].append(small)
        for entry in bench["end_to_end"] + bench["per_layer"]:
            if cell["name"] in entry.get("workloads", ()):
                entry["workloads"].append(small["name"])
    return Registry(bench, [root])


@pytest.fixture
def small(tmp_path):
    return small_registry(tmp_path)
