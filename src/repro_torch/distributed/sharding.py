"""Logical-axis sharding: rules mapping logical tensor axes to mesh dims.

Tensors are annotated with *logical* axis names ("embed", "heads",
"edge", ...). A rule-set maps each to physical mesh dims ("pod", "data",
"model"). The rules, and the specs they give, are the JAX package's
(``repro.distributed.sharding``), so a spec here equals
``tuple(PartitionSpec)`` there for the same mesh shape and rules.

A spec is a tuple with one entry per tensor dim: a mesh dim name, a
tuple of names (the dim split over them, the first one major), or None.
A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims,
or any object whose ``shape`` maps dim names to sizes (enough to compute
specs without a process group).

``use_rules(mesh)`` installs the mesh and rules that the engine's edge
fold (``shard_edges=True``) and the models read. ``shard_as(x, *axes)``
is the counterpart of ``with_sharding_constraint``: under a mesh, a
DTensor is redistributed to the placements of its axes' spec; a plain
tensor, or any tensor without a mesh, comes back as it is. The model
runs under a mesh as DTensor ops (the counterpart of GSPMD), with
plain tensors it creates itself (positions, masks) treated as replicated
(``implicit_replication``, see :func:`model_context`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

Axis = Union[str, Tuple[str, ...], None]
Spec = Tuple[Axis, ...]

# The default rule-set for a ("pod", "data", "model") or ("data", "model")
# mesh. "fsdp" is the param shard axis for ZeRO-3-style fully-sharded
# params (maps to "data").
BASE_RULES: Dict[str, Axis] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "decode_cache_seq": "model",
    "embed_act": None,
    # params
    "vocab": "model",
    "embed": None,
    "embed_fsdp": "data",          # FSDP shard dim for 2D+ params
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "head_dim_tp": "model",        # fallback TP when heads % model != 0
    "ff": "model",
    "expert": "model",
    "q_lora": None,
    "kv_lora": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "conv": None,
    "layers": None,
    "moe_capacity": None,
    # graph mining (repro_torch.engine): edge lists shard over every mesh
    # dim — fixed-size sketches make per-edge work uniform, so any split
    # balances
    "edge": ("pod", "data", "model"),
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Dict[str, Axis] = dict(BASE_RULES)


_CTX = _Ctx()


def axis_sizes(mesh) -> Dict[str, int]:
    """The mesh's dim name -> size map (a DeviceMesh's named dims, or the
    ``shape`` mapping of any other mesh object)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    if not isinstance(mesh.shape, Mapping):
        raise ValueError("a mesh needs named dims (mesh_dim_names) or a "
                         "shape that maps dim names to sizes")
    return dict(mesh.shape)


def active_mesh():
    """The mesh installed by ``use_rules`` (None outside any context)."""
    return _CTX.mesh


@contextlib.contextmanager
def use_rules(mesh, overrides: Optional[Dict[str, Axis]] = None):
    """Install ``mesh`` and ``BASE_RULES`` updated by ``overrides`` for
    the calls inside the ``with`` block (per thread)."""
    prev_mesh, prev_rules = _CTX.mesh, _CTX.rules
    rules = dict(BASE_RULES)
    if overrides:
        rules.update(overrides)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev_mesh, prev_rules


def same_rules():
    """A context that installs the mesh and rules active now, and
    :func:`model_context` under them. Autograd runs a CUDA backward on a
    thread of its own, where this module's per-thread context is empty;
    a layer recomputed there (remat) must see the forward's rules
    (``torch.utils.checkpoint``'s ``context_fn``)."""
    mesh, rules = _CTX.mesh, _CTX.rules

    @contextlib.contextmanager
    def ctx():
        prev = _CTX.mesh, _CTX.rules
        _CTX.mesh, _CTX.rules = mesh, rules
        try:
            with model_context():
                yield
        finally:
            _CTX.mesh, _CTX.rules = prev

    return ctx()


def _filter_axes(sizes: Dict[str, int], phys: Axis, dim_size: int,
                 used: set) -> Axis:
    """Drop mesh dims that don't divide the tensor dim or are already used."""
    if phys is None:
        return None
    axes = (phys,) if isinstance(phys, str) else tuple(phys)
    kept = []
    size = 1
    for a in axes:
        if a not in sizes or a in used:
            continue
        if dim_size % (size * sizes[a]) != 0:
            continue
        kept.append(a)
        size *= sizes[a]
    if not kept:
        return None
    used.update(kept)
    return tuple(kept) if len(kept) > 1 else kept[0]


def spec_for(logical_axes: Sequence[Optional[str]],
             dim_sizes: Optional[Sequence[int]] = None,
             mesh=None, rules: Optional[Dict[str, Axis]] = None) -> Spec:
    """Logical axes -> spec under the active (or given) mesh and rules.

    With ``dim_sizes`` a mesh dim is kept only where it divides the tensor
    dim; no mesh dim serves two tensor dims.
    """
    mesh = mesh if mesh is not None else _CTX.mesh
    rules = rules or _CTX.rules
    sizes = axis_sizes(mesh) if mesh is not None else None
    used: set = set()
    parts = []
    for i, name in enumerate(logical_axes):
        phys = rules.get(name) if name else None
        if sizes is not None and phys is not None:
            if dim_sizes is not None:
                phys = _filter_axes(sizes, phys, dim_sizes[i], used)
            else:
                axes = (phys,) if isinstance(phys, str) else tuple(phys)
                axes = tuple(a for a in axes if a in sizes and a not in used)
                used.update(axes)
                phys = axes if len(axes) > 1 else (axes[0] if axes else None)
        parts.append(phys)
    return tuple(parts)


def mesh_index(mesh, axes: Sequence[str]) -> int:
    """This rank's row-major index over the mesh dims ``axes`` (the first
    one major): the shard of a tensor dim split over them that it holds."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index = 0
    for a in axes:
        index = index * sizes[a] + coord[a]
    return index


def spec_axes(entry: Axis) -> Tuple[str, ...]:
    """A spec entry's mesh dims as a tuple (empty for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: how one tensor is laid out over the mesh, the
    counterpart of ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> list:
        """The DTensor placements of this sharding, one per mesh dim:
        ``Shard(d)`` where the spec splits tensor dim d over the mesh dim,
        ``Replicate()`` elsewhere. DTensor splits a tensor dim over
        several mesh dims in mesh order, so a spec that names them in
        another order raises."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(axis_sizes(self.mesh))
        out = [Replicate() for _ in names]
        for dim, entry in enumerate(self.spec):
            axes = spec_axes(entry)
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(f"spec entry {entry!r} lists mesh dims out "
                                 f"of the mesh's order {tuple(names)}")
            for i in order:
                out[i] = Shard(dim)
        return out


def shard_as(x, *logical_axes: Optional[str]):
    """Constrain a DTensor's layout to its logical axes' spec under the
    active mesh (a redistribute, which is a no-op when it already lies
    so); ``x`` itself without an active mesh or when it is a plain
    tensor."""
    mesh = _CTX.mesh
    if mesh is None or not is_dtensor(x):
        return x
    sh = NamedSharding(x.device_mesh, spec_for(logical_axes,
                                               dim_sizes=tuple(x.shape),
                                               mesh=x.device_mesh))
    placements = sh.placements
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor laid out over a mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def gathered(w):
    """A weight as a product reads it: a DTensor split over the data dims
    ("pod", "data"; ZeRO-3 at rest) all-gathered over them, its split over
    "model" kept (the GSPMD gather of an FSDP weight; its gradient is
    reduce-scattered back). Anything else comes back as it is."""
    return replicated_over(w, "pod", "data")


def replicated_over(x, *dims: str):
    """A DTensor replicated over the mesh dims ``dims`` (all-gathered
    where it is split there); ``x`` itself when it is a plain tensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    names = x.device_mesh.mesh_dim_names
    placements = [Replicate() if n in dims else pl
                  for n, pl in zip(names, x.placements)]
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def shard_dims(x, dim: int) -> list:
    """The mesh dims (indices) over which DTensor ``x`` splits its tensor
    dim ``dim``."""
    from torch.distributed.tensor import Shard

    return [i for i, pl in enumerate(x.placements) if pl == Shard(dim)]


def layout(mesh, **by_index) -> list:
    """Placements, one per mesh dim: ``by_index`` maps a placement to the
    mesh dims (indices) it holds on, Replicate elsewhere; e.g.
    ``layout(mesh, shard0=[0], partial=[1])``. Keys: ``shard<d>`` (Shard
    of tensor dim d) and ``partial``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    out = [Replicate()] * mesh.ndim
    for key, dims in by_index.items():
        pl = Partial() if key == "partial" else Shard(int(key[5:]))
        for i in dims:
            out[i] = pl
    return out


def partial_over(placements, dims) -> list:
    """``placements`` with ``Partial`` on the mesh dims ``dims``: the
    gradient layout of an input whose ranks along them use it for other
    tokens (or heads, or experts), so that each rank's gradient is a
    part of the sum."""
    from torch.distributed.tensor import Partial

    out = list(placements)
    for i in dims:
        out[i] = Partial()
    return out


def run_local(fn, mesh, args, in_placements, out_placements,
              grad_placements=None):
    """``fn`` on each rank's local shards of ``args`` (redistributed to
    ``in_placements`` first), its output the DTensor of
    ``out_placements`` (``local_map``). ``grad_placements`` are the
    inputs' gradient layouts: an input replicated over a mesh dim whose
    ranks use it differently (other tokens, other heads) gets a partial
    gradient there, which must be declared ``Partial``."""
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=(tuple(grad_placements)
                                         if grad_placements else None),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def model_context():
    """The context a model step runs in: under an active mesh DTensor's
    ``implicit_replication`` (a plain tensor the model makes, such as a
    position or a mask, is replicated on every rank, so it may meet a
    DTensor); nothing otherwise."""
    if _CTX.mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def distribute(x, sharding: "NamedSharding"):
    """A tensor that every rank holds whole, as a DTensor laid out by
    ``sharding``: each rank keeps its own shard, with no communication
    (``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def sharding_for_tree(axes_tree, shapes_tree, mesh,
                      overrides: Optional[Dict[str, Axis]] = None):
    """A :class:`NamedSharding` tree for a tree of logical-axes tuples and
    the matching tree of shapes (or tensors/arrays with ``.shape``).
    Dicts, lists and tuples of axes tuples are walked; ``None`` stays."""
    rules = dict(BASE_RULES)
    if overrides:
        rules.update(overrides)

    def walk(axes, shape):
        if axes is None:
            return None
        if _is_axes_leaf(axes):
            dims = shape.shape if hasattr(shape, "shape") else shape
            return NamedSharding(mesh, spec_for(axes, dim_sizes=tuple(dims),
                                                mesh=mesh, rules=rules))
        if isinstance(axes, dict):
            return {k: walk(v, shape[k]) for k, v in axes.items()}
        if isinstance(axes, (list, tuple)):
            out = [walk(a, s) for a, s in zip(axes, shape)]
            return out if isinstance(axes, list) else tuple(out)
        raise TypeError(f"not a logical-axes tuple or a container: {axes!r}")

    return walk(axes_tree, shapes_tree)
