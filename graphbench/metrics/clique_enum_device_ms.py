"""``clique_enum_device_ms``: device milliseconds per job that the
4-clique pass spends outside the segmented popcount kernel: the
enumeration of wedges, the closing test and the compaction of survivors
(operations launched while the job's ``cliques4`` phase was open)."""

UNIT, LAYER, MOVES = "ms", "clique enumeration", "mined_edges_per_s.cliques4"


def read(t):
    if t.device is None or not t.device.jobs:
        return None
    s = t.device.seconds_where(
        lambda op: op.phase == "cliques4"
        and "segment_popcount_kernel" not in op.name)
    return 1e3 * s / t.device.jobs if s > 0 else None
