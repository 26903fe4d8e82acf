"""Finds the benchmark's parts by the names ``BENCHMARK.json`` gives them.

A cell ``<config>.<mix>`` is one entry of ``workloads``. Its parts are
files, found by name under each of ``roots`` in turn (the benchmark's own
folder last), so a later change adds a configuration, a traffic mix, a job
kind or a per-layer metric by adding files and never edits one:

  configs/<config>.json   the deployment: generator law and scale, sketch
  mixes/<mix>.json        the traffic: job kind, loop, seeds, checked jobs
  jobs/<kind>.py          one job's calls into the program and its checks
  metrics/<metric>.py     one per-layer metric's reader

A metric named ``<quantity>.<part>`` is ``<quantity>`` split by cells
that report different end-to-end metrics (or take different bounds): it
reads with ``<quantity>``'s reader and value unless it has its own file.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Sequence

HERE = Path(__file__).resolve().parent
#: the checkout's root, which holds BENCHMARK.json and src/
ROOT = HERE.parent

_MODULES: Dict[Path, ModuleType] = {}


class Registry:
    """The benchmark description and the folders its parts are found in."""

    def __init__(self, bench: dict, roots: Sequence[Path] = ()):
        self.bench = bench
        self.roots: List[Path] = [Path(r) for r in roots] + [HERE]

    @classmethod
    def load(cls, path: Path = ROOT / "BENCHMARK.json",
             roots: Sequence[Path] = ()) -> "Registry":
        with open(path) as fh:
            return cls(json.load(fh), roots)

    def _find(self, folder: str, name: str, suffix: str) -> Path:
        for root in self.roots:
            path = root / folder / f"{name}{suffix}"
            if path.is_file():
                return path
        raise KeyError(f"no {folder}/{name}{suffix} under "
                       f"{[str(r) for r in self.roots]}")

    def cell(self, workload: str) -> dict:
        for cell in self.bench["workloads"]:
            if cell["name"] == workload:
                return cell
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        with open(self._find("configs", name, ".json")) as fh:
            return json.load(fh)

    def mix(self, name: str) -> dict:
        with open(self._find("mixes", name, ".json")) as fh:
            return json.load(fh)

    def job(self, kind: str) -> ModuleType:
        return _module(self._find("jobs", kind, ".py"), f"job_{kind}")

    def metric(self, name: str) -> ModuleType:
        """The reader of metric ``name``; a name ``<quantity>.<part>``
        without a file of its own reads with ``<quantity>``'s."""
        try:
            path = self._find("metrics", name, ".py")
        except KeyError:
            if "." not in name:
                raise
            path = self._find("metrics", name.split(".")[0], ".py")
        return _module(path, "metric_" + path.stem.replace(".", "_"))

    def metrics_of(self, section: str, workload: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` entries a cell reports."""
        return [m for m in self.bench[section]
                if workload in m.get("workloads", [workload])]


def _module(path: Path, name: str) -> ModuleType:
    """The module in the file ``path``, loaded once per process."""
    mod: Optional[ModuleType] = _MODULES.get(path)
    if mod is None:
        full = f"graphbench.found.{name}"
        spec = importlib.util.spec_from_file_location(full, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[full] = mod
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return mod
