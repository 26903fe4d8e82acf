"""Per-device cost of a step, counted from the ops it dispatches: the
port's counterpart of ``repro.analysis.hlo``.

The reference parses the optimized HLO of a compiled step. The port's
step is eager, so :func:`analyze` runs it once under a counting
``TorchDispatchMode`` (:class:`OpCounter`) and counts every aten op that
reaches this rank's tensors:

  * flops: the formulas of ``torch.utils.flop_counter`` (mm, bmm, addmm,
    baddbmm, convolutions, SDPA) and :data:`FLOP_FORMULAS` for the port's
    own ops (the flash-attention kernel's forward);
  * bytes_proxy: every input and output byte of each op that is not a
    view (eager ops do not fuse, so each one reads and writes memory;
    XLA's fusion would save some of these bytes);
  * transcendentals: the outputs of exp, log, tanh, sigmoid, rsqrt, ...;
  * collectives: the functional collectives (what DTensor's redistribute
    and ``_functional_collectives`` issue), their payload and ring-model
    link bytes by the reference's formulas (``hlo.py``: all-reduce
    2(g-1)/g of its input, all-gather and reduce-scatter (g-1)/g of the
    larger side, all-to-all (g-1)/g of its input), the group size g read
    from the process group.

Only ops on local tensors count. An op on DTensors is handed on
(``NotImplemented``) and counted as the local ops it becomes, and the
ops that DTensor runs on global shapes to infer an output's shape (its
sharding propagation) are hidden (:func:`quiet_shape_propagation`);
counting both would add the global work to the local.
``dot_flops_by_meta`` keys a product's flops by the innermost module that
ran it (``ModTracker``, the module tracker of ``MemTracker``);
``while_trip_counts`` stays empty: an eager loop is counted as it runs.
The counts are per rank, as the reference's post-partitioning HLO is per
device.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_aten = torch.ops.aten


@dataclasses.dataclass
class OpStats:
    """``HloStats``' fields, counted from dispatched ops."""
    flops: float = 0.0
    bytes_proxy: float = 0.0
    transcendentals: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_link_bytes: float = 0.0   # ring-model bytes over the slowest link
    collective_ops: Dict[str, int] = dataclasses.field(default_factory=dict)
    dot_flops_by_meta: Dict[str, float] = dataclasses.field(default_factory=dict)
    while_trip_counts: List[int] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _attention_flops(q, k, v, window, *args, **kwargs) -> float:
    """Causal (optionally windowed) attention forward over q [B, Sq, H,
    D], k/v [B, Skv, KV, D]: 4·D flops (QKᵀ and PV) for each (query, key)
    pair the mask keeps, the last query aligned with the last key."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    lo, hi = max(1, skv - sq + 1), skv       # keys seen by the first, last
    cap = int(window) or hi
    top = min(hi, cap)                        # below the window: n keys
    pairs = (lo + top) * (top - lo + 1) // 2 if top >= lo else 0
    pairs += cap * max(0, hi - max(lo, cap + 1) + 1)   # the rest: the window
    return 4.0 * b * h * d * pairs


#: flop formulas of the port's own ops, by op name: f(*args) -> flops
FLOP_FORMULAS: Dict[str, Callable[..., float]] = {
    "repro_torch::flash_attention": _attention_flops,
}

#: ops that move no data: views, allocation and metadata
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default, _aten._local_scalar_dense.default,
             _aten.detach.default, _aten.lift_fresh.default,
             _aten.alias.default, _aten.set_.source_Storage_storage_offset}

_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf", "silu",
                   "gelu", "softplus", "_softmax", "_log_softmax", "pow"}

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-broadcast",
    "broadcast_": "collective-broadcast",
}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


@contextlib.contextmanager
def quiet_shape_propagation():
    """Hide from every dispatch mode (this counter, ``MemTracker``) the
    ops that DTensor's sharding propagator runs on global shapes to infer
    an output's shape: they run with the current modes set aside (in a
    fake mode of their own). Counting them would add global work and
    global-size tensors to a rank's."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def quiet(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = quiet
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _group_size(group_name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name).size()


class OpCounter(TorchDispatchMode):
    """A dispatch mode that adds each local op's cost to :attr:`stats`."""

    def __init__(self, root: Optional[torch.nn.Module] = None):
        super().__init__()
        from torch.distributed._tools.mod_tracker import ModTracker

        self.stats = OpStats()
        self._modules = ModTracker()
        if root is not None:  # name modules by their path in the root
            for name, mod in root.named_modules():
                self._modules._known_modules[mod] = name or type(root).__name__

    def __enter__(self):
        self._modules.__enter__()
        self._prop = quiet_shape_propagation()
        self._prop.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._prop.__exit__(*exc)
        self._modules.__exit__(*exc)
        return out

    def _module_path(self) -> str:
        parents = [p for p in self._modules.parents if p != "Global"]
        return max(parents, key=len) if parents else "Global"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        flat = tree_leaves((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, flat, out)
        return out

    def _count(self, func, args, kwargs, flat, out) -> None:
        st = self.stats
        name = func.__name__.split(".")[0]
        ns = func.namespace
        if ns == "_c10d_functional":
            kind = _COLLECTIVES.get(name)
            if kind is None:
                return
            group = args[-1]
            g = _group_size(group)
            in_b = _nbytes(args[0])
            out_b = sum(_nbytes(o) for o in tree_leaves(out))
            payload = max(in_b, out_b)
            if kind == "all-reduce":
                link = 2.0 * (g - 1) / g * in_b
            elif kind in ("all-gather", "reduce-scatter"):
                link = (g - 1) / g * payload
            elif kind == "all-to-all":
                link = (g - 1) / g * in_b
            else:
                link = in_b
            st.collective_bytes[kind] = st.collective_bytes.get(kind, 0.0) \
                + payload
            st.collective_link_bytes += link
            st.collective_ops[kind] = st.collective_ops.get(kind, 0) + 1
            return
        flops = self._flops(func, args, kwargs, out)
        if flops:
            st.flops += flops
            key = self._module_path()
            st.dot_flops_by_meta[key] = st.dot_flops_by_meta.get(key, 0.0) \
                + flops
        if name in _TRANSCENDENTAL:
            st.transcendentals += sum(o.numel() for o in tree_leaves(out)
                                      if isinstance(o, torch.Tensor))
        if func in _NO_BYTES or ns == "prim" or (
                ns == "aten" and func.is_view):
            return
        st.bytes_proxy += sum(_nbytes(a) for a in flat) + sum(
            _nbytes(o) for o in tree_leaves(out))

    @staticmethod
    def _flops(func, args, kwargs, out) -> float:
        from torch.utils.flop_counter import flop_registry

        own = FLOP_FORMULAS.get(
            f"{func.namespace}::{func.__name__.split('.')[0]}")
        if own is not None:
            return float(own(*args, **kwargs))
        formula = flop_registry.get(func._overloadpacket)
        if formula is None:
            return 0.0
        return float(formula(*args, **kwargs, out_val=out))


def _find_module(args) -> Optional[torch.nn.Module]:
    for a in args:
        for x in (a.values() if isinstance(a, dict) else (a,)):
            if isinstance(x, torch.nn.Module):
                return x
    return None


def analyze(fn: Callable, *args, **kwargs) -> OpStats:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter` and
    return this rank's counts; products are keyed by their module's path
    in the first module among the arguments (or a dict argument's
    values, such as a train state's ``params``)."""
    with OpCounter(_find_module(args)) as counter:
        fn(*args, **kwargs)
    return counter.stats


__all__ = ["FLOP_FORMULAS", "OpCounter", "OpStats", "analyze"]
