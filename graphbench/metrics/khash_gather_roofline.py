"""``khash_gather_roofline``: share of its roofline that the k-Hash
match-count gather kernel (``khash_kernel`` on ``GatherSrc``, in
``mh_intersect.cu``) reaches over a job's per-edge pass.

The work is counted from the job's inputs as the algorithm needs them:
every sketch row an edge names read once (the vertices with an edge, k
ids each), two ids read and one count written per edge; per edge and
hash function a compare and an add.
"""
from graphbench import peaks
from graphbench.reference.sketches import khash_k

UNIT, LAYER, MOVES = "%", "kernels", "mined_edges_per_s"


def work(t):
    """(bytes, integer operations, popcounts) of one job's k-Hash match
    counts."""
    k = khash_k(t.n, t.m, t.config["storage_budget"])
    return t.rows_named * k * 4 + t.m * 12, t.m * k * 2, 0


def _is_kernel(op):
    return "khash_kernel" in op.name and "GatherSrc" in op.name


def read(t):
    # over several ranks the work counted is the whole graph's and the
    # time rank 0's: nothing to read until the work is counted a rank
    if t.world > 1 or t.device is None or not t.device.jobs:
        return None
    kernel_s = t.device.seconds_where(_is_kernel) / t.device.jobs
    return peaks.roofline_percent(work(t), kernel_s)
