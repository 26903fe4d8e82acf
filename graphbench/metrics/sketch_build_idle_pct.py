"""``sketch_build_idle_pct``: share of the profiled job's ``sketch.build``
span (the sketch build, fenced on the sketch data) in which no operation
ran on the device."""
from graphbench.metrics.edge_pass_idle_pct import idle_pct

UNIT, LAYER, MOVES = "%", "sketch build", "mined_edges_per_s"


def read(t):
    return idle_pct(t, "sketch.build")
