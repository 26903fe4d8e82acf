"""ProbGraph core: probabilistic set representations for graph mining.

Paper: Besta et al., "ProbGraph: High-Performance and High-Accuracy Graph
Mining with Probabilistic Set Representations" (CS.DC 2022).
"""
from . import bounds, estimators, exact, graph, hashing, intersect, sketches
from .graph import Graph, erdos_renyi, from_edge_array, kronecker
from .intersect import make_pair_cardinality_fn
from .sketches import SketchSet, build

__all__ = [
    "Graph", "SketchSet", "bounds", "build", "erdos_renyi", "estimators",
    "exact", "from_edge_array", "graph", "hashing", "intersect", "kronecker",
    "make_pair_cardinality_fn", "sketches",
]
