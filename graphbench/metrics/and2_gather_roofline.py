"""``and2_gather_roofline``: share of its roofline that the Bloom AND2
gather popcount (``tile_popcount_kernel`` on ``GatherSrc``, in
``fused_expr.cu``) reaches over a job's per-edge pass.

The work is counted from the job's inputs as the algorithm needs them,
whatever the chunking: every sketch row an edge names read once (the
vertices with an edge, W words each), two ids read and one count written
per edge; per edge and word an AND and an add (integer operations) and a
popcount, counted apart (``peaks.POPC_PER_S``).
"""
from graphbench import peaks
from graphbench.reference.sketches import bloom_words

UNIT, LAYER, MOVES = "%", "kernels", "mined_edges_per_s"


def work(t):
    """(bytes, integer operations, popcounts) of one job's AND2
    popcounts."""
    w = bloom_words(t.n, t.m, t.config["storage_budget"])
    return t.rows_named * w * 4 + t.m * 12, t.m * w * 2, t.m * w


def _is_kernel(op):
    return "tile_popcount_kernel" in op.name and "GatherSrc" in op.name


def read(t):
    # over several ranks the work counted is the whole graph's and the
    # time rank 0's: nothing to read until the work is counted a rank
    if t.world > 1 or t.device is None or not t.device.jobs:
        return None
    kernel_s = t.device.seconds_where(_is_kernel) / t.device.jobs
    return peaks.roofline_percent(work(t), kernel_s)
