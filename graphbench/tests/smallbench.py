"""Small copies of the benchmark's cells for its tests, on the CPU.

``small_registry`` gives a :class:`~graphbench.registry.Registry` whose
extra root (a temporary folder) holds the shipped configurations at a
small scale and the shipped mixes tracing job 0 and checking the jobs
right after it, and whose ``BENCHMARK.json`` copy has one cell
``small_<config>.<mix>`` per shipped cell. ``rank_registry`` adds a cell
of the test-only job kind ``mine_ranks`` (``parts/``) over k ranks.

(A module of its own, not ``conftest``, so that a session that also
collects another folder's ``conftest`` imports the right one.)
"""
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from graphbench.registry import Registry  # noqa: E402

SCALE = 8

#: the test-only parts: the job kind ``mine_ranks`` and its mix
PARTS = Path(__file__).resolve().parent / "parts"


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


def rank_registry(root: Path, chips: int, scale: int = SCALE,
                  traffic: str = "mine_ranks", **mix_keys) -> tuple:
    """(registry, cell): ``small_registry`` with the configuration
    ``small_kron<scale>_bf`` (``kron21_bf`` at ``scale``) and its cell
    ``small_kron<scale>_bf.<traffic>`` of the job kind ``mine_ranks`` over
    ``chips`` ranks, whose mix adds ``mix_keys``. The cell reports the
    rate, memory and set-up, and ``csr_build_s`` when traced."""
    reg = small_registry(root, scale)
    reg.roots.insert(1, PARTS)
    cfg = reg.config("kron21_bf")
    cfg["name"] = f"small_kron{scale}_bf"
    cfg["scale"] = scale
    (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    mix = dict(reg.mix("mine_ranks"), **mix_keys)
    (root / "mixes" / f"{traffic}.json").write_text(json.dumps(mix))
    cell = f"{cfg['name']}.{traffic}"
    reg.bench["workloads"].append({"name": cell, "config": cfg["name"],
                                   "traffic": traffic, "chips": chips})
    for entry in reg.bench["end_to_end"] + reg.bench["per_layer"]:
        if entry["name"] in ("mined_edges_per_s", "csr_build_s"):
            entry["workloads"].append(cell)
    return reg, cell
