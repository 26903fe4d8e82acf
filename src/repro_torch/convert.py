"""Carry state from the reference's arrays, given as numpy, into the port.

The parity tests hand one graph and one sketch to both packages through
these functions, so both sides see the same integers; and one model, or
one train state (parameters, optimizer state, compression errors), so
both sides take the same step. :func:`reference_tree` maps the port's
per-layer tensors back onto the reference's stacked layout.
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


def port_leaves(tree, cfg) -> dict:
    """A reference tree shaped like ``init_params``'s (``blocks[b][slot]``
    stacked over repeats) as ``{port name: leaf}``: layer ``i``'s leaves
    under ``layers.i.``, the others under their dotted paths. Leaves below
    a parameter (Adafactor's ``{"vr", "vc"}``) come as ``<name>.<key>``."""
    out = {}
    for key, value in tree.items():
        if key == "blocks":
            for i, layer in enumerate(unstack_layers(value, cfg)):
                _dotted(layer, f"layers.{i}.", out)
        elif isinstance(value, dict):
            _dotted(value, f"{key}.", out)
        else:
            out[key] = value
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, value in flat.items():
        *path, last = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[last] = value
    return out


def reference_tree(flat, cfg) -> dict:
    """The inverse of :func:`port_leaves`: ``{port name: tensor or array}``
    (parameters, gradients, optimizer moments, ``<name>.<key>`` leaves) as
    the reference's tree, each block's layers stacked along a leading
    repeat axis; leaves as numpy arrays (bfloat16 tensors widened to
    float32, which numpy holds)."""
    from .models.model import build_plan

    per_layer: dict = {}
    rest = {}
    for name, value in flat.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu()
            if value.dtype == torch.bfloat16:
                value = value.float()
        arr = np.asarray(value)
        parts = name.split(".")
        if parts[0] == "layers":
            per_layer.setdefault(int(parts[1]), {})[
                ".".join(parts[2:])] = arr
        else:
            rest[name] = arr
    out = _nest(rest)
    if per_layer:
        blocks, i = [], 0
        for blk in build_plan(cfg):
            slots = [[] for _ in blk.sigs]
            for _ in range(blk.repeat):
                for si in range(len(blk.sigs)):
                    slots[si].append(per_layer[i])
                    i += 1
            blocks.append([_nest({k: np.stack([layer[k] for layer in reps])
                                  for k in reps[0]}) for reps in slots])
        out["blocks"] = blocks
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
    flat = port_leaves(params, cfg)
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


def train_state_from_numpy(state, cfg, device: DeviceLike = DEFAULT_DEVICE):
    """A port train state (``distributed.step``'s layout) holding the
    numbers of the reference's: ``params`` (:func:`model_params_from_numpy`,
    requiring grad), ``opt`` (AdamW's ``mu``, ``nu``, ``master``,
    Adafactor's ``v`` of ``{"vr", "vc"}`` or ``{"v"}``, and ``step``) and
    ``ef``, each leaf per layer under the parameter's name, float32."""
    dev = resolve_device(device)
    model = model_params_from_numpy(state["params"], cfg, dev)
    names = [n for n, _ in model.named_parameters()]

    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    def by_name(tree):
        flat = port_leaves(tree, cfg)
        if set(flat) != set(names):
            raise ValueError(f"leaves differ from the parameters: "
                             f"{sorted(set(flat) ^ set(names))}")
        return {n: f32(flat[n]) for n in names}

    opt = {}
    for key, tree in state["opt"].items():
        if key == "step":
            opt[key] = torch.tensor(int(np.asarray(tree)), dtype=torch.int32,
                                    device=dev)
        elif key == "v":
            moments: dict = {}
            for leaf, arr in port_leaves(tree, cfg).items():
                name, part = leaf.rsplit(".", 1)
                moments.setdefault(name, {})[part] = f32(arr)
            if set(moments) != set(names):
                raise ValueError("Adafactor moments differ from the "
                                 "parameters")
            opt[key] = moments
        else:
            opt[key] = by_name(tree)
    out = {"params": model.requires_grad_(True), "opt": opt}
    if "ef" in state:
        out["ef"] = by_name(state["ef"])
    return out
