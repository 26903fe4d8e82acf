"""Accuracy telemetry: sketch fill ratios and live error-interval gauges.

The accuracy side of ProbGraph's speed/accuracy tradeoff, recorded at run
time into a :class:`~repro_torch.obs.metrics.MetricsRegistry`:

- :func:`fill_ratio` — how saturated a sketch is (Bloom bit density, or the
  fraction of occupied MinHash/KMV slots). A Bloom filter past ~0.5 fill is
  the leading indicator of estimate inflation.
- :func:`record_pair_error` — per-answered-query error-interval estimates
  from ``core.bounds`` (RMSE for Bloom AND-cardinality, the Chernoff-style
  multiplicative scale for the MinHash family), as gauges next to the
  serving counters.
- :func:`record_maintenance` — the ``ErrorBudgetPolicy`` dirty-row /
  rebuild counters from ``SketchMaintainer.stats()``.

The fill ratio is counted on the sketch's device: Bloom rows are int32 bit
patterns, so it popcounts them with the SWAR popcount of
``core.estimators`` and moves one integer to the host. The other helpers
are host numpy on values the caller already has.
"""
from __future__ import annotations

import numpy as np

from .metrics import REGISTRY, MetricsRegistry


def fill_ratio(sketch) -> float:
    """Mean occupancy of a ``SketchSet`` in [0, 1].

    Bloom (``bf``): mean set-bit density over all rows. MinHash family
    (``kh``/``1h``): fraction of slots holding a real vertex id (< n).
    KMV: fraction of slots below the pad sentinel.
    """
    data = sketch.data
    size = data.numel()
    if size == 0:
        return 0.0
    if sketch.kind == "bf":
        from ..core.estimators import popcount32
        return int(popcount32(data).sum()) / (size * 32)
    if sketch.kind in ("kh", "1h"):
        return int((data < sketch.n).sum()) / size
    if sketch.kind == "kmv":
        from ..core.sketches import KMV_PAD
        return int((data < KMV_PAD).sum()) / size
    return 0.0


def record_fill(sketch, registry: MetricsRegistry = REGISTRY) -> float:
    """Record :func:`fill_ratio` as ``sketch_fill_ratio{kind=...}``."""
    ratio = fill_ratio(sketch)
    registry.gauge("sketch_fill_ratio", kind=sketch.kind).set(ratio)
    return ratio


def record_pair_error(sketch, cards, du, dv,
                      registry: MetricsRegistry = REGISTRY) -> dict:
    """Record live error-interval estimates for a batch of pair answers.

    ``cards`` are the estimated intersection cardinalities just served;
    ``du``/``dv`` the endpoint degrees (host arrays). Emits, labelled by
    sketch kind:

    - ``accuracy_err_rmse`` — mean absolute error estimate (Bloom: Thm IV.2
      RMSE at the answered cardinality; MinHash family: epsilon·min-degree
      from the multiplicative concentration bound).
    - ``accuracy_err_rel`` — the same normalized by ``max(card, 1)``.

    Returns the recorded ``{"rmse", "rel"}`` dict.
    """
    from ..core import bounds

    cards = np.asarray(cards, dtype=np.float64)
    du = np.asarray(du, dtype=np.float64)
    dv = np.asarray(dv, dtype=np.float64)
    if cards.size == 0:
        return {"rmse": 0.0, "rel": 0.0}
    if sketch.kind == "bf":
        err = bounds.bf_and_rmse(cards, sketch.total_bits, sketch.num_hashes)
        err = np.asarray(err, dtype=np.float64)
    else:
        eps = bounds.minhash_error_scale(np.minimum(du, dv),
                                         max(int(sketch.k), 1))
        err = np.asarray(eps, dtype=np.float64) * np.minimum(du, dv)
    rmse = float(np.mean(err))
    rel = float(np.mean(err / np.maximum(cards, 1.0)))
    registry.gauge("accuracy_err_rmse", kind=sketch.kind).set(rmse)
    registry.gauge("accuracy_err_rel", kind=sketch.kind).set(rel)
    return {"rmse": rmse, "rel": rel}


def record_maintenance(stats: dict,
                       registry: MetricsRegistry = REGISTRY) -> None:
    """Mirror ``SketchMaintainer.stats()`` into the registry.

    Emits ``sketch_rows_dirty`` / ``sketch_stale_total`` gauges and keeps
    ``sketch_rows_rebuilt`` / ``sketch_rows_incremental`` /
    ``sketch_deltas_applied`` counters in sync (set, not inc — the
    maintainer's plain-int counters stay the source of truth).
    """
    kind = str(stats.get("kind", "?"))
    registry.gauge("sketch_rows_dirty", kind=kind).set(
        float(stats.get("rows_dirty", 0)))
    registry.gauge("sketch_stale_total", kind=kind).set(
        float(stats.get("stale_total", 0.0)))
    for field in ("rows_rebuilt", "rows_incremental", "deltas_applied"):
        registry.counter(f"sketch_{field}", kind=kind).set(
            int(stats.get(field, 0)))


__all__ = ["fill_ratio", "record_fill", "record_maintenance",
           "record_pair_error"]
