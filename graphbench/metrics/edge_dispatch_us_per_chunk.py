"""``edge_dispatch_us_per_chunk``: host microseconds per edge chunk that
the per-edge pass takes to enqueue its work: the ``engine.edge_cards``
span's ``enqueue_us`` (its start to its fence) over its ``chunks``; the
median over the jobs of the window."""
import statistics

UNIT, LAYER, MOVES = "us", "engine", "mined_edges_per_s"


def read(t):
    per_chunk = [ev["enqueue_us"] / ev["args"]["chunks"] for ev in t.spans
                 if ev["name"] == "engine.edge_cards" and "enqueue_us" in ev
                 and ev["args"].get("chunks")]
    return statistics.median(per_chunk) if per_chunk else None
