"""``edge_pass_ms``: milliseconds of the program's ``engine.edge_cards``
span (the per-edge cardinality pass, fenced while tracing is on); the
median over the jobs of the window."""
import statistics

UNIT, LAYER, MOVES = "ms", "engine", "mined_edges_per_s"


def read(t):
    ms = [ev["dur"] * 1e-3 for ev in t.spans
          if ev["name"] == "engine.edge_cards"]
    return statistics.median(ms) if ms else None
