"""``clique_pass_idle_pct``: share of the profiled job's ``clique.count``
span (the clique pass, fenced on the count) in which no operation ran on
the device: the host between pieces and at each piece's wait."""
from graphbench.metrics.edge_pass_idle_pct import idle_pct

UNIT, LAYER, MOVES = "%", "clique enumeration", "mined_edges_per_s.cliques4"


def read(t):
    return idle_pct(t, "clique.count")
