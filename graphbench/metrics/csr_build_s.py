"""``csr_build_s``: seconds the program's load path, ``from_edge_array``,
takes to turn the raw edge array into the device CSR (host clock around
the call, synchronised); part of ``setup_s``."""

UNIT, LAYER, MOVES = "s", "graph load", "setup_s"


def read(t):
    return t.csr_build_s
