"""Job kind ``cliques4``: count the 4-cliques of the graph. One job opens
a new Bloom mining session (the sketch build) and estimates the 4-clique
count: (1/4)·Σ over the triangles u < v < w that the Bloom closing test
keeps of Eq. 2 on popcount(B_u & B_v & B_w).

Compared with the reference for each checked job: the sketch words, the
wedge candidates and closed triangles the enumeration counted (the
program's ``clique_*`` gauges) and the estimate.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.engine import api as engine
from repro_torch.obs.metrics import REGISTRY

from graphbench import checks
from graphbench.reference import mining, sketches

#: limit of each compared number; counts of differing integers are 0
LIMITS = {"sketch_diff": 0.0, "wedge_diff": 0.0, "triangle_diff": 0.0,
          "cc4_gap": 1e-6}


def run(ctx, seed: int, probe) -> dict:
    """One job through the program; returns once its answer is ready."""
    cfg = ctx.config
    with probe.phase("build"):
        sess = engine.session(ctx.graph, cfg["sketch"],
                              storage_budget=cfg["storage_budget"],
                              num_hashes=cfg["num_hashes"], seed=seed,
                              device=ctx.device)
    with probe.phase("cliques4"):
        estimate = float(sess.four_clique_count())
    return {"sketch": sess.sketch.data, "estimate": estimate,
            "wedge_candidates": int(
                REGISTRY.gauge("clique_wedge_candidates").value),
            "triangles": int(REGISTRY.gauge("clique_triangles").value)}


def counters(out: dict) -> dict:
    """Program counters a per-layer metric reads."""
    return {"triangles": out["triangles"],
            "wedge_candidates": out["wedge_candidates"]}


def keep(out: dict) -> dict:
    """The answers of a checked job."""
    return out


def reference(ctx, rg, seed: int, dtype: torch.dtype) -> dict:
    """The same job by the plain reference, floats in ``dtype``."""
    cfg = ctx.config
    words = sketches.bloom_words(rg.n, rg.m, cfg["storage_budget"])
    data = sketches.bloom(rg, words, cfg["num_hashes"], seed)
    out = mining.four_cliques(rg, data, cfg["num_hashes"], seed, dtype)
    return {"sketch": data, **out}


def compare(got: dict, want: dict, rg) -> List[checks.Check]:
    """The compared numbers of one job's answers against the reference's."""
    gap = abs(got["estimate"] - want["estimate"]) / abs(want["estimate"])
    values = {
        "sketch_diff": checks.mismatches(got["sketch"], want["sketch"]),
        "wedge_diff": abs(got["wedge_candidates"]
                          - want["wedge_candidates"]),
        "triangle_diff": abs(got["triangles"] - want["triangles"]),
        "cc4_gap": gap if gap == gap else float("inf"),
    }
    return [checks.Check(k, float(v), LIMITS[k]) for k, v in values.items()]
