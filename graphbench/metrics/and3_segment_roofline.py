"""``and3_segment_roofline``: share of its roofline that the segmented
AND3 popcount (``segment_popcount_kernel``, in ``fused_expr.cu``)
reaches over a job's 4-clique pass.

The work is counted from the job's inputs as the algorithm needs them:
every sketch row read once (the vertices with an edge, W words each),
one id read and one count written per closed triangle (the program's
``clique_triangles`` gauge); per triangle and word an AND and an add
(integer operations) and a popcount, counted apart (the AND of a
segment's two head rows is shared by its tuples).
"""
import statistics

from graphbench import peaks
from graphbench.reference.sketches import bloom_words

UNIT, LAYER, MOVES = "%", "kernels", "mined_edges_per_s.cliques4"


def work(t):
    """(bytes, integer operations, popcounts) of one job's AND3
    popcounts."""
    w = bloom_words(t.n, t.m, t.config["storage_budget"])
    tuples = statistics.mean(c["triangles"] for c in t.job_counters)
    return t.rows_named * w * 4 + tuples * 8, tuples * w * 2, tuples * w


def _is_kernel(op):
    return "segment_popcount_kernel" in op.name


def read(t):
    # over several ranks the work counted is the whole graph's and the
    # time rank 0's: nothing to read until the work is counted a rank
    if (t.world > 1 or t.device is None or not t.device.jobs
            or not t.job_counters):
        return None
    kernel_s = t.device.seconds_where(_is_kernel) / t.device.jobs
    return peaks.roofline_percent(work(t), kernel_s)
