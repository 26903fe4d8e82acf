"""Cost analysis: per-device counts of a step's ops (``cost``), the
roofline terms on H100s (``roofline``) and live roofline gauges
(``live``)."""
from . import cost, live, roofline

__all__ = ["cost", "live", "roofline"]
