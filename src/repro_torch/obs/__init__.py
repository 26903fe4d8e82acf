"""Observability: span tracing, the metrics registry, accuracy telemetry.

- :mod:`repro_torch.obs.trace` — structured span tracer on the profiler's
  epoch-nanosecond clock, with Chrome-trace/Perfetto export; ``sp.fence``
  stamps the enqueue and synchronizes CUDA work.
- :mod:`repro_torch.obs.metrics` — labelled counter/gauge/histogram registry.
- :mod:`repro_torch.obs.accuracy` — sketch fill-ratio and live error-bound
  gauges.

``obs`` depends only on numpy and the stdlib (plus a lazy ``torch`` import
for span fencing and profiler annotations), so every other layer may import it.
"""
from . import accuracy, metrics, trace
from .metrics import REGISTRY, MetricsRegistry
from .trace import span

__all__ = ["REGISTRY", "MetricsRegistry", "accuracy", "metrics", "span",
           "trace"]
