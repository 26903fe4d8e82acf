"""``idle_pct``: share of the traced stretch of jobs in which no
operation ran on the device."""

UNIT, LAYER, MOVES = "%", "device", "mined_edges_per_s"


def read(t):
    if t.device is None or t.device.window_s <= 0 or not t.device.ops:
        return None
    return 100.0 * (1.0 - t.device.busy_s / t.device.window_s)
