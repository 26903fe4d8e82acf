"""The peaks a roofline share is taken against: one NVIDIA H100 SXM
(80 GB HBM3) at its 700 W limit, from NVIDIA's data sheet, the SM count
and boost clock, and the CUDA C++ Programming Guide's table of arithmetic
instruction throughput (results per clock an SM, compute capability 9.0).
"""

#: HBM3 bandwidth, bytes per second
HBM_BYTES_PER_S = 3.35e12

#: 32-bit integer adds, compares and bitwise operations per second: 64
#: results a clock an SM × 132 SMs × 1,980 MHz
INT32_OPS_PER_S = 64 * 132 * 1.98e9

#: 32-bit population counts (``__popc``) per second: 16 results a clock an
#: SM × 132 SMs × 1,980 MHz
POPC_PER_S = 16 * 132 * 1.98e9


def least_seconds(nbytes: float, ops: float, popcounts: float = 0.0
                  ) -> float:
    """The least time a kernel moving ``nbytes``, doing ``ops`` integer
    operations and ``popcounts`` population counts can take: the largest
    of its three bounds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S,
               popcounts / POPC_PER_S)


def roofline_percent(work: tuple, kernel_s: float):
    """100 × least time of ``work`` (the arguments of ``least_seconds``)
    ÷ the kernel's time; None when it did not run."""
    if kernel_s <= 0:
        return None
    return 100.0 * least_seconds(*work) / kernel_s
