"""Graph-mining algorithms over ProbGraph estimators (TC and LCC so far)."""
from .tc import local_clustering_coefficient, triangle_count

__all__ = ["local_clustering_coefficient", "triangle_count"]
