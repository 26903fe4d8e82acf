"""ProbGraph core: probabilistic set representations for graph mining.

Paper: Besta et al., "ProbGraph: High-Performance and High-Accuracy Graph
Mining with Probabilistic Set Representations" (CS.DC 2022).
"""
from . import bounds, estimators, exact, graph, hashing, intersect, sketches
from .graph import (Graph, barabasi_albert, erdos_renyi, from_edge_array,
                    kronecker, random_bipartite_community)
from .intersect import make_pair_cardinality_fn
from .sketches import SketchSet, build
from .algorithms import link_prediction_effectiveness

__all__ = [
    "Graph", "SketchSet", "barabasi_albert", "bounds", "build",
    "erdos_renyi", "estimators", "exact", "from_edge_array", "graph",
    "hashing", "intersect", "kronecker", "link_prediction_effectiveness",
    "make_pair_cardinality_fn", "random_bipartite_community", "sketches",
]
