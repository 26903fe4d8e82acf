"""Graph-mining algorithms over ProbGraph estimators (TC, LCC, Jarvis–Patrick
clustering and the cardinality-based similarities so far)."""
from .clustering import jarvis_patrick
from .similarity import pair_similarity, similarity_from_cardinalities
from .tc import local_clustering_coefficient, triangle_count

__all__ = ["jarvis_patrick", "local_clustering_coefficient",
           "pair_similarity", "similarity_from_cardinalities",
           "triangle_count"]
