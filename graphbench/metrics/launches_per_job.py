"""``launches_per_job``: kernels the device ran per job in the profiled
jobs (copies and fills not counted)."""

UNIT, LAYER, MOVES = "launches", "engine", "mined_edges_per_s"


def read(t):
    if t.device is None or not t.device.jobs:
        return None
    kernels = sum(op.is_kernel for op in t.device.ops)
    return kernels / t.device.jobs if kernels else None
