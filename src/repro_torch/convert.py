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


def adaptive_from_numpy(data, words, num_hashes: int, seed: int,
                        device: DeviceLike = DEFAULT_DEVICE):
    """A port :class:`~repro_torch.core.adaptive.AdaptiveBloom` from the
    reference's ``uint32[n, words_max]`` matrix and its ``words[n]``: row v
    keeps its first ``words[v]`` words, packed in the ragged layout."""
    from .core.adaptive import AdaptiveBloom

    arr = np.ascontiguousarray(data)
    if arr.dtype not in (np.uint32, np.int32):
        raise ValueError(f"an adaptive Bloom sketch must be uint32 or "
                         f"int32, got {arr.dtype}")
    arr = arr.view(np.int32)
    w = np.asarray(words, dtype=np.int64)
    n, words_max = arr.shape
    flat = arr[np.arange(words_max)[None, :] < w[:, None]]
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(w, out=offsets[1:])
    dev = resolve_device(device)
    return AdaptiveBloom(
        data=torch.from_numpy(flat.copy()).to(dev),
        offsets=torch.from_numpy(offsets).to(dev),
        words=torch.from_numpy(w.astype(np.int32)).to(dev),
        num_hashes=int(num_hashes), seed=int(seed), n=int(n),
        words_max=int(words_max))


def unstack_layers(blocks, cfg) -> list:
    """The reference's stacked ``blocks[b][slot]`` trees (leaves with a
    leading ``repeat`` axis), parameters or caches, as one tree per layer
    in the port's layer order (block by block, repeat-major)."""
    from .models.model import build_plan

    def pick(tree, r):
        if isinstance(tree, dict):
            return {k: pick(v, r) for k, v in tree.items()}
        return np.asarray(tree)[r]

    return [pick(slots[si], r)
            for blk, slots in zip(build_plan(cfg), blocks)
            for r in range(blk.repeat) for si in range(len(blk.sigs))]


def _dotted(tree, prefix: str, out: dict) -> dict:
    for k, v in tree.items():
        if isinstance(v, dict):
            _dotted(v, f"{prefix}{k}.", out)
        else:
            out[prefix + k] = v
    return out


def model_params_from_numpy(params, cfg,
                            device: DeviceLike = DEFAULT_DEVICE):
    """A port :class:`~repro_torch.models.Model` holding the numbers of the
    reference's ``init_params`` tree (leaves as numpy arrays, or anything
    ``np.asarray`` takes), any of its layer signatures (attention, MLA,
    SSM; MLP, MoE with its shared expert). Every leaf must match a weight
    of the port's model in name and shape, and every weight must be given.
    Each weight keeps the port's type, which is the reference leaf's: the
    MoE router and the SSM's ``a_log``, ``d_skip`` and ``dt_bias`` stay
    float32 in a bf16 model."""
    from .models.model import Model

    dev = resolve_device(device)
    model = Model(cfg, None, dev)
    flat = {k: v for k, v in params.items() if k != "blocks"
            and not isinstance(v, dict)}
    for i, layer in enumerate(unstack_layers(params["blocks"], cfg)):
        _dotted(layer, f"layers.{i}.", flat)
    state = model.state_dict()
    if set(flat) != set(state):
        raise ValueError(f"reference leaves and port weights differ: only "
                         f"in the reference {sorted(set(flat) - set(state))}, "
                         f"only in the port {sorted(set(state) - set(flat))}")
    with torch.no_grad():
        for name, t in state.items():
            arr = np.array(flat[name], dtype=np.float32)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{name}: reference shape {arr.shape}, "
                                 f"port shape {tuple(t.shape)}")
            t.copy_(torch.from_numpy(arr))
    return model
