"""The plain reference that decides ``correct``.

Plain PyTorch, independent of the program under test: it imports nothing
of ``repro_torch``, ``repro`` or JAX, and works out from the raw edge
array that both sides are given everything the program derives (the CSR,
the sketches, the per-edge counts, the estimates). Floating-point results
are computed in the dtype the caller names: float64 for the reference,
bfloat16 for the control that the comparison has to reject.
"""
