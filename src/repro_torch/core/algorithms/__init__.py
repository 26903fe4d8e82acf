"""Graph-mining algorithms over ProbGraph estimators (TC, LCC, 4- and
5-cliques, Jarvis–Patrick clustering and the cardinality-based
similarities so far)."""
from .cliques import five_clique_count, four_clique_count
from .clustering import jarvis_patrick
from .similarity import pair_similarity, similarity_from_cardinalities
from .tc import local_clustering_coefficient, triangle_count

__all__ = ["five_clique_count", "four_clique_count", "jarvis_patrick",
           "local_clustering_coefficient", "pair_similarity",
           "similarity_from_cardinalities", "triangle_count"]
