"""Carry state from the reference's arrays, given as numpy, into the port.

The parity tests hand one graph and one sketch to both packages through
these functions, so both sides see the same integers.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import DEFAULT_DEVICE, DeviceLike, resolve_device
from .core.graph import Graph
from .core.sketches import SketchSet


def graph_from_numpy(indptr, indices, deg, edges, n: int, m: int, d_max: int,
                     device: DeviceLike = DEFAULT_DEVICE) -> Graph:
    """A port ``Graph`` from the reference's CSR arrays (int32)."""
    dev = resolve_device(device)

    def t(x, shape):
        return torch.from_numpy(
            np.array(x, dtype=np.int32).reshape(shape)).to(dev)

    return Graph(indptr=t(indptr, (n + 1,)), indices=t(indices, (-1,)),
                 deg=t(deg, (n,)), edges=t(edges, (m, 2)), n_vertices=int(n),
                 n_edges=int(m), d_max=int(d_max))


#: the numpy types a reference sketch matrix of each kind may have
_SKETCH_DTYPES = {"bf": (np.uint32, np.int32), "kh": (np.int32,),
                  "1h": (np.int32,), "kmv": (np.float32,)}


def sketch_from_numpy(data, kind: str, num_hashes: int, k: int,
                      seed: int, n: int,
                      device: DeviceLike = DEFAULT_DEVICE) -> SketchSet:
    """A port ``SketchSet`` from the reference's sketch matrix.

    Bloom words (uint32) are stored as int32 bit patterns; k-Hash and
    1-Hash rows stay int32 and KMV rows float32. Any other type raises.
    """
    arr = np.ascontiguousarray(data)
    if kind not in _SKETCH_DTYPES:
        raise ValueError(f"unknown sketch kind: {kind}")
    allowed = _SKETCH_DTYPES[kind]
    if arr.dtype not in allowed:
        names = " or ".join(t.__name__ for t in allowed)
        raise ValueError(f"a {kind!r} sketch must be {names}, got {arr.dtype}")
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    data = torch.from_numpy(arr.copy()).to(resolve_device(device))
    return SketchSet(data=data, kind=kind, num_hashes=int(num_hashes),
                     k=int(k), seed=int(seed), n=int(n))
