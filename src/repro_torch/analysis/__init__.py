"""Model arithmetic for bounds: the flops of a forward or a decode step."""
from . import roofline

__all__ = ["roofline"]
