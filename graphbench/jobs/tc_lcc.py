"""Job kind ``tc_lcc``: an analyst's "triangles and clustering of this
graph". One job opens a new mining session (the sketch build), counts
triangles and computes every vertex's local clustering coefficient over
the session's one per-edge pass.

Compared with the reference for each checked job: the sketch words, the
per-edge counts behind the cardinalities (popcounts of the ANDed Bloom
rows, or k-Hash matches, recovered exactly from the float32 cardinality,
whose every count step moves it by more than its rounding), the per-edge
cardinalities, the triangle count and the clustering coefficients. The
limits of the floating-point gaps are set between the largest reading of
sound runs and the smallest of the control (PERF.md §2).
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.engine import api as engine

from graphbench import checks
from graphbench.reference import mining, sketches

#: limit of each compared number; counts of differing integers are 0
LIMITS = {"sketch_diff": 0.0, "count_diff": 0.0, "card_gap": 1e-4,
          "tc_gap": 1e-4, "lcc_gap": 1e-2}


def run(ctx, seed: int, probe) -> dict:
    """One job through the program; returns once its answers are ready."""
    cfg = ctx.config
    with probe.phase("build"):
        sess = engine.session(ctx.graph, cfg["sketch"],
                              storage_budget=cfg["storage_budget"],
                              num_hashes=cfg["num_hashes"], seed=seed,
                              device=ctx.device)
    with probe.phase("tc"):
        tc = float(sess.triangle_count())
    with probe.phase("lcc"):
        lcc = sess.local_clustering()
        ctx.sync()
    return {"sketch": sess.sketch.data, "cards": sess.edge_cardinalities(),
            "tc": tc, "lcc": lcc}


def counters(out: dict) -> dict:
    """Program counters a per-layer metric reads (none for this kind)."""
    return {}


def keep(out: dict) -> dict:
    """The answers of a checked job."""
    return out


def reference(ctx, rg, seed: int, dtype: torch.dtype) -> dict:
    """The same job by the plain reference, floats in ``dtype``."""
    cfg = ctx.config
    kind = cfg["sketch"]
    if kind == "bf":
        words = sketches.bloom_words(rg.n, rg.m, cfg["storage_budget"])
        data = sketches.bloom(rg, words, cfg["num_hashes"], seed)
        params = {"total_bits": 32 * words, "num_hashes": cfg["num_hashes"]}
    else:
        k = sketches.khash_k(rg.n, rg.m, cfg["storage_budget"])
        data = sketches.khash(rg, k, seed)
        params = {"k": k}
    counts, cards = mining.edge_cardinalities(rg, kind, data, params, dtype)
    return {"kind": kind, "params": params, "sketch": data,
            "counts": counts, "cards": cards,
            "tc": float(mining.triangle_count(cards)),
            "lcc": mining.local_clustering(rg, cards)}


def recovered_counts(cards: torch.Tensor, want: dict, rg) -> torch.Tensor:
    """The per-edge counts that float cardinalities were computed from,
    by inverting Eq. 2 (Bloom) or Eq. 5 (k-Hash) in float64 and rounding."""
    c = cards.to(rg.deg.device, torch.float64)
    p = want["params"]
    if want["kind"] == "bf":
        total = p["total_bits"]
        x = -total * torch.expm1(-c * p["num_hashes"] / total)
        return torch.round(x).to(torch.int64)
    s = (rg.deg[rg.edges[:, 0]] + rg.deg[rg.edges[:, 1]]).to(torch.float64)
    return torch.round(p["k"] * c / (s - c)).to(torch.int64)


def compare(got: dict, want: dict, rg) -> List[checks.Check]:
    """The compared numbers of one job's answers against the reference's."""
    counts = want["counts"]
    if want["kind"] == "bf":
        counts = torch.clamp(counts, max=want["params"]["total_bits"] - 1)
    tc_gap = abs(got["tc"] - want["tc"]) / abs(want["tc"])
    values = {
        "sketch_diff": checks.mismatches(got["sketch"], want["sketch"]),
        "count_diff": checks.mismatches(
            recovered_counts(got["cards"], want, rg), counts),
        "card_gap": checks.relative_gap(got["cards"], want["cards"]),
        "tc_gap": tc_gap if tc_gap == tc_gap else float("inf"),
        "lcc_gap": checks.relative_gap(got["lcc"], want["lcc"]),
    }
    return [checks.Check(k, float(v), LIMITS[k]) for k, v in values.items()]
