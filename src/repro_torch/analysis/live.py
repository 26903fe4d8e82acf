"""Live roofline accounting: the counted cost of a step against its
measured wall time.

The port of ``repro.analysis.live``. :func:`record_roofline` takes a step
(a callable, run once under the cost counter, :func:`.cost.analyze`) or
its counts (:class:`.cost.OpStats`) and a measured wall time, computes the
roofline lower bound ``max(flops / PEAK_FLOPS_BF16, bytes_proxy /
HBM_BW)`` and publishes the achieved share of it as
``roofline_fraction{op=...}`` and ``roofline_bound_s{op=...}`` gauges in
the metrics registry.
"""
from __future__ import annotations

from typing import Optional

from ..obs.metrics import REGISTRY, MetricsRegistry
from .cost import OpStats, analyze
from .roofline import HBM_BW, PEAK_FLOPS_BF16


def op_cost(fn, *args, **kwargs) -> OpStats:
    """The counted cost of one call ``fn(*args, **kwargs)``."""
    return analyze(fn, *args, **kwargs)


def roofline_bound_s(stats: OpStats) -> float:
    """Roofline lower-bound runtime (s): compute-bound vs. memory-bound."""
    return max(stats.flops / PEAK_FLOPS_BF16, stats.bytes_proxy / HBM_BW)


def record_roofline(name: str, fn_or_stats, wall_s: float,
                    registry: Optional[MetricsRegistry] = None) -> dict:
    """Gauge the achieved-vs-roofline fraction for one measured op.

    ``fn_or_stats`` is its counts or a no-argument callable that runs it
    once. ``fraction = bound_s / wall_s``: 1.0 means running at the
    roofline, small values mean overhead-dominated. Sets
    ``roofline_fraction{op=name}`` and ``roofline_bound_s{op=name}`` and
    returns ``{"flops", "bytes_proxy", "bound_s", "wall_s",
    "fraction"}``.
    """
    reg = REGISTRY if registry is None else registry
    stats = fn_or_stats if isinstance(fn_or_stats, OpStats) \
        else op_cost(fn_or_stats)
    bound = roofline_bound_s(stats)
    fraction = bound / wall_s if wall_s > 0 else 0.0
    reg.gauge("roofline_fraction", op=name).set(fraction)
    reg.gauge("roofline_bound_s", op=name).set(bound)
    return {"flops": stats.flops, "bytes_proxy": stats.bytes_proxy,
            "bound_s": bound, "wall_s": wall_s, "fraction": fraction}


__all__ = ["op_cost", "record_roofline", "roofline_bound_s"]
