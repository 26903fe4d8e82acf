"""Graph-mining algorithms over ProbGraph estimators (TC, LCC, 4- and
5-cliques, Jarvis–Patrick clustering, vertex similarities and local
clustering)."""
from .cliques import five_clique_count, four_clique_count
from .clustering import jarvis_patrick
from .localcluster import (LocalClusterResult, local_cluster, ppr_push,
                           sweep_cut)
from .similarity import pair_similarity, similarity_from_cardinalities
from .tc import local_clustering_coefficient, triangle_count

__all__ = ["LocalClusterResult", "five_clique_count", "four_clique_count",
           "jarvis_patrick", "local_cluster", "local_clustering_coefficient",
           "pair_similarity", "ppr_push", "similarity_from_cardinalities",
           "sweep_cut", "triangle_count"]
