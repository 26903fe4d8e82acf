"""Observability: span tracing and the metrics registry.

- :mod:`repro_torch.obs.trace` — structured span tracer with
  Chrome-trace/Perfetto export; ``sp.fence`` synchronizes CUDA work.
- :mod:`repro_torch.obs.metrics` — labelled counter/gauge/histogram registry.

``obs`` depends only on numpy and the stdlib (plus a lazy ``torch`` import
for span fencing), so every other layer may import it.
"""
from . import metrics, trace
from .metrics import REGISTRY, MetricsRegistry
from .trace import span, traced

__all__ = ["REGISTRY", "MetricsRegistry", "metrics", "span", "trace",
           "traced"]
