"""``clique_pass_syncs``: device-to-host copies that ran inside the
``clique.count`` span, per profiled job. Each is a point where the host
waited for the device (a piece's ``nonzero``, a count read back)."""
from graphbench.metrics.edge_pass_idle_pct import job_spans

UNIT, LAYER, MOVES = "syncs", "clique enumeration", \
    "mined_edges_per_s.cliques4"


def read(t):
    spans = job_spans(t, "clique.count")
    if not spans or not t.device.jobs:
        return None
    copies = sum(
        1 for op in t.device.ops if op.name.startswith("Memcpy DtoH")
        and any(ev["t0_ns"] <= op.start_ns < ev["t1_ns"] for ev in spans))
    return copies / t.device.jobs
