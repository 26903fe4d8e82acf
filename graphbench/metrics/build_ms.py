"""``build_ms``: device milliseconds of a job's ``session(...)`` call,
the sketch build, between two CUDA events; the median over the jobs of
the window."""
import statistics

UNIT, LAYER, MOVES = "ms", "sketch build", "mined_edges_per_s"


def read(t):
    ms = t.phase_ms.get("build")
    return statistics.median(ms) if ms else None
