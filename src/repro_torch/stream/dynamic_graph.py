"""Mutable graph store for the streaming subsystem.

``DynamicGraph`` keeps a host (numpy) source of truth for an undirected
graph on a fixed vertex set [0, n) whose edges arrive and depart in
batches, and a :class:`DeviceGraphState` mirror on the device that every
delta keeps current with delta-sized uploads.

The layout holds no padded adjacency. The JAX package keeps a host
``adj[n, cap]`` (cap = 1.5 · d_max) and its device twin; at a Kronecker
graph of scale 21 that array would take 1.29 TB on each side. Here:

* **Host**: the sorted canonical keys ``lo·n + hi`` (``edge_keys``), the
  degrees, and the sorted *directed* keys ``src·n + dst`` over both
  directions, which is CSR order: ``neighbors(v)`` is a ``searchsorted``
  slice of them. The three arrays form one immutable generation
  (:class:`_HostState`); a delta builds the next one and rebinds it, never
  writing into a published array, so a :class:`HostGraphSnapshot` is a
  reference to one generation and needs no copy-on-write overlay or lock.
* **Device**: ``deg``, the capacity-padded canonical edge list
  ``edges[e_cap, 2]`` (sentinel rows ``(n, n)`` past m) and the CSR
  ``indptr``/``indices``. A delta uploads only the deleted positions, the
  inserted edges, the touched vertices and their degrees; the edge splice
  (one sort of an int64 key in which sentinels sort last) and the CSR
  (a cumsum and one sort of the directed keys) are re-derived on the
  device, O(m) device work and no O(m) bytes over the bus.

Every generation of the device state is built out of place and published
by one attribute swap, so a reader that captured a generation (a
``view()`` graph pinned by an in-flight flush) keeps a consistent version.

Edge identity is the canonical key ``lo·n + hi`` (u < v), kept as one
sorted int64 array so delta application is vectorized set algebra, as in
the reference. The refresh's carry comes from the device splice, so the
reference's host ``carry_index`` (a search of every edge key) has no
counterpart here.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, DeviceLike, resolve_device
from ..core.graph import (Graph, canonical_edge_keys, device_csr,
                          from_edge_array, graph_view)
from ..engine.plan import pow2_bucket
from ..obs import trace
from ..obs.metrics import MetricsRegistry


@dataclasses.dataclass(frozen=True)
class DeltaResult:
    """What one ``apply_delta`` actually changed (post-canonicalization).

    Attributes:
      inserted: int64[I, 2]  newly present edges (u < v).
      deleted:  int64[D, 2]  removed edges (u < v).
      touched:  int64[T]     sorted unique vertices with any adjacency change.
      dirty:    int64[Dv]    sorted unique vertices that *lost* a neighbor
                             (their sketches cannot be updated monotonically).
      version:  graph version after this delta.
    """

    inserted: np.ndarray
    deleted: np.ndarray
    touched: np.ndarray
    dirty: np.ndarray
    version: int

    @property
    def is_noop(self) -> bool:
        """True when the delta changed nothing (all edges already as asked)."""
        return self.inserted.size == 0 and self.deleted.size == 0

    def insert_rows(self, n: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The inserts as a CSR of the delta: per vertex, its new neighbors.

        Returns ``(verts int32[T], indptr int64[T+1], nbrs int32[2I])``:
        vertex ``verts[i]`` gained ``nbrs[indptr[i]:indptr[i+1]]``, sorted
        ascending, and ``verts`` is sorted. No row is padded, so a hub that
        gains many neighbors costs no more than its own entries.
        """
        if self.inserted.size == 0:
            return (np.zeros(0, np.int32), np.zeros(1, np.int64),
                    np.zeros(0, np.int32))
        u, v = self.inserted[:, 0], self.inserted[:, 1]
        directed = np.sort(np.concatenate([u * n + v, v * n + u]))
        src, dst = directed // n, directed % n
        verts, counts = np.unique(src, return_counts=True)
        indptr = np.zeros(verts.size + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        return verts.astype(np.int32), indptr, dst.astype(np.int32)


class TrafficMeter:
    """Host → device upload accounting for the streaming delta path.

    ``put()`` is the single doorway every streaming upload goes through, so
    ``bytes_delta`` (reset by ``begin_delta``) is an *exact* measure of host
    traffic per delta. Init-time puts copy the host buffer first: on the
    CPU ``torch.from_numpy(...).to("cpu")`` aliases the numpy buffer, and a
    tensor must never share memory with a host array something else owns;
    delta-path callers pass freshly built buffers, so they skip the copy.

    The numbers live in a :class:`~repro_torch.obs.metrics.MetricsRegistry`
    (``traffic_bytes{path=init|delta}``, ``traffic_bytes_last_delta``,
    ``traffic_steps``); ``bytes_init`` etc. and the ``stats()`` dict are
    views over those instruments, with the reference's names and shape.
    """

    def __init__(self, device: torch.device,
                 registry: Optional[MetricsRegistry] = None):
        self.device = device
        self.registry = MetricsRegistry() if registry is None else registry
        self._init = self.registry.counter("traffic_bytes", path="init")
        self._total = self.registry.counter("traffic_bytes", path="delta")
        self._last = self.registry.gauge("traffic_bytes_last_delta")
        self._steps = self.registry.counter("traffic_steps")

    @property
    def bytes_init(self) -> int:
        """One-time device residency bytes (session open)."""
        return self._init.value

    @property
    def bytes_total(self) -> int:
        """Cumulative delta-path upload bytes."""
        return self._total.value

    @property
    def bytes_delta(self) -> int:
        """Upload bytes since the last ``begin_delta()``."""
        return int(self._last.value)

    @property
    def steps(self) -> int:
        """Committed delta/flush traffic steps."""
        return self._steps.value

    def begin_delta(self):
        """Reset the per-delta byte counter (called at each delta's start)."""
        self._last.set(0)

    def commit_step(self):
        """Count one real delta/flush step (no-op steps stay unmetered so
        ``bytes_per_delta_mean`` reflects deltas that did work)."""
        self._steps.inc()

    def put(self, arr: np.ndarray, init: bool = False) -> torch.Tensor:
        """Upload a host buffer, metering its bytes (init vs delta path)."""
        host = np.array(arr, copy=True) if init else np.ascontiguousarray(arr)
        if init:
            self._init.inc(host.nbytes)
        else:
            self._last.add(host.nbytes)
            self._total.inc(host.nbytes)
        return torch.from_numpy(host).to(self.device)

    def stats(self) -> dict:
        """Upload accounting: init/total/last-delta bytes and step count."""
        return {
            "bytes_init": self.bytes_init,
            "bytes_total": self.bytes_total,
            "bytes_last_delta": self.bytes_delta,
            "bytes_per_delta_mean": self.bytes_total / max(self.steps, 1),
            "steps": self.steps,
        }


def _splice_edges(edges: torch.Tensor, del_pos: torch.Tensor,
                  ins_uv: torch.Tensor, m_old: int, n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Delta-sized splice of the canonical-order device edge list.

    ``edges`` is int32[e_cap, 2]: valid edges in key order at [0, m_old),
    sentinel rows (n, n) after. Deleted positions become sentinels, inserts
    land in the free slots [m_old, m_old + I), and one sort of the int64
    key ``lo·(n+1) + hi`` restores canonical order with the sentinels last.
    Returns the new buffer (the input is not written) and the position
    carry: ``carry[j]`` is new edge j's position in the *old* order, or -1
    for an insert (and for sentinel rows).
    """
    e_cap = edges.shape[0]
    dev = edges.device
    pos = torch.arange(e_cap, device=dev)
    deleted = torch.zeros(e_cap, dtype=torch.bool, device=dev)
    deleted[del_pos.to(torch.int64)] = True
    work = torch.where(deleted[:, None], n, edges)
    n_ins = ins_uv.shape[0]
    if n_ins:
        work[m_old:m_old + n_ins] = ins_uv
    key = work[:, 0].to(torch.int64) * (n + 1) + work[:, 1].to(torch.int64)
    order = torch.sort(key).indices
    old_flag = (pos < m_old) & ~deleted
    carry = torch.where(old_flag[order], order, -1)
    return work[order], carry


class _DeviceBuffers(NamedTuple):
    # one immutable generation of the device mirror: swapped wholesale at
    # the end of every delta so concurrent readers never see a half-applied
    # generation (deg from version N+1, edges still at N)
    deg: torch.Tensor
    edges: torch.Tensor
    indptr: torch.Tensor
    indices: torch.Tensor
    e_cap: int
    m: int
    d_max: int


class DeviceGraphState:
    """Persistent device mirror of a DynamicGraph: deg, edges and the CSR.

    Created once per session (one upload of deg, the edge buffer and the
    CSR, metered as ``bytes_init``); afterwards every delta is absorbed from
    delta-sized uploads. Edge-buffer growth happens on the device by
    sentinel padding to the next power of two — still no full-graph upload.

    Each delta builds the next generation out of place and publishes it with
    one attribute swap: a reader that captured the published tensors — a
    ``view()`` graph pinned by an in-flight flush — keeps a consistent
    version-N world no matter how many deltas land meanwhile.
    """

    def __init__(self, dyn: "DynamicGraph", meter: TrafficMeter):
        self.n = dyn.n
        self.meter = meter
        e_cap = pow2_bucket(max(dyn.m, 1))
        edges = np.full((e_cap, 2), dyn.n, dtype=np.int32)
        edges[:dyn.m] = dyn.edge_array()
        host = dyn._host
        indptr = np.zeros(dyn.n + 1, dtype=np.int32)
        np.cumsum(host.deg, out=indptr[1:])
        indices = (host.dir_keys % max(dyn.n, 1)).astype(np.int32)
        self._buf = _DeviceBuffers(
            meter.put(host.deg, init=True), meter.put(edges, init=True),
            meter.put(indptr, init=True), meter.put(indices, init=True),
            e_cap, dyn.m, host.d_max)
        self.last_carry: Optional[torch.Tensor] = None
        self._identity: Optional[torch.Tensor] = None

    @property
    def deg(self) -> torch.Tensor:
        """Published device degree vector int32[n]."""
        return self._buf.deg

    @property
    def edges(self) -> torch.Tensor:
        """Published device edge list int32[e_cap, 2] (sentinel-padded)."""
        return self._buf.edges

    @property
    def indptr(self) -> torch.Tensor:
        """Published device CSR row pointers int32[n+1]."""
        return self._buf.indptr

    @property
    def indices(self) -> torch.Tensor:
        """Published device CSR neighbor ids int32[2m]."""
        return self._buf.indices

    @property
    def e_cap(self) -> int:
        """Published edge-buffer capacity."""
        return self._buf.e_cap

    @property
    def m(self) -> int:
        """Edge count of the published generation."""
        return self._buf.m

    def identity_carry(self) -> torch.Tensor:
        """Position carry of a no-splice step (flush-triggered rebuilds)."""
        if self._identity is None or self._identity.shape[0] != self.e_cap:
            self._identity = torch.arange(self.e_cap,
                                          device=self._buf.deg.device)
        return self._identity

    def apply_delta(self, dyn: "DynamicGraph", delta: DeltaResult,
                    del_pos: np.ndarray, m_old: int) -> None:
        """Mirror one already-applied host delta with delta-sized uploads."""
        with trace.span("graph.device_delta", touched=int(delta.touched.size),
                        inserted=int(delta.inserted.shape[0]),
                        deleted=int(delta.deleted.shape[0])) as dsp:
            self._apply_delta(dyn, delta, del_pos, m_old)
            dsp.fence(self._buf.indices)

    def _apply_delta(self, dyn: "DynamicGraph", delta: DeltaResult,
                     del_pos: np.ndarray, m_old: int) -> None:
        """The untraced body of :meth:`apply_delta` — shadow build + swap."""
        n = self.n
        deg, edges, e_cap = self._buf.deg, self._buf.edges, self._buf.e_cap
        touched = delta.touched
        if touched.size:
            verts = self.meter.put(touched.astype(np.int32)).to(torch.int64)
            degs = self.meter.put(dyn.deg[touched].astype(np.int32))
            deg = deg.clone()
            deg[verts] = degs
        n_ins = int(delta.inserted.shape[0])
        with trace.span("graph.splice_edges", inserts=n_ins,
                        deletes=int(del_pos.size)) as ssp:
            if e_cap < m_old + n_ins:        # edge buffer growth, on device
                new_cap = pow2_bucket(m_old + n_ins)
                edges = torch.cat([edges, torch.full(
                    (new_cap - e_cap, 2), n, dtype=torch.int32,
                    device=edges.device)])
                e_cap = new_cap
            dpos = self.meter.put(del_pos.astype(np.int32))
            iuv = self.meter.put(delta.inserted.astype(np.int32).reshape(
                -1, 2))
            edges, self.last_carry = _splice_edges(edges, dpos, iuv, m_old,
                                                   n)
            ssp.fence(edges)
        with trace.span("graph.csr", edges=dyn.m) as csp:
            indptr, indices = device_csr(n, deg, edges[:dyn.m])
            csp.fence(indices)
        # publication: one swap — no reader ever observes a mix of
        # generations
        self._buf = _DeviceBuffers(deg, edges, indptr, indices, e_cap, dyn.m,
                                   dyn.d_max)


class _HostState(NamedTuple):
    # one immutable generation of the host source of truth; a delta builds
    # the next one and rebinds DynamicGraph._host, so a reader holding a
    # generation never sees it change
    edge_keys: np.ndarray     # sorted int64[m], key = lo*n + hi (lo < hi)
    deg: np.ndarray           # int32[n]
    dir_keys: np.ndarray      # sorted int64[2m], key = src*n + dst
    d_max: int                # max(max degree, 1)


def _host_state(edge_keys: np.ndarray, deg: np.ndarray,
                dir_keys: np.ndarray) -> _HostState:
    """A read-only host generation over the given arrays."""
    for arr in (edge_keys, deg, dir_keys):
        arr.setflags(write=False)
    d_max = max(int(deg.max()) if deg.size else 0, 1)
    return _HostState(edge_keys, deg, dir_keys, d_max)


def _neighbors(n: int, dir_keys: np.ndarray, v: int) -> np.ndarray:
    """Sorted neighbor ids of ``v`` (int32) from the directed keys."""
    v = int(v)
    lo, hi = np.searchsorted(dir_keys, [v * n, (v + 1) * n])
    return (dir_keys[lo:hi] - v * n).astype(np.int32)


class HostGraphSnapshot:
    """Frozen host-side view of a :class:`DynamicGraph` at one version.

    Captures one host generation by reference. Deltas rebind the graph's
    generation and never write into a published array (they are read-only
    numpy arrays), so the snapshot stays valid across any number of later
    deltas at no cost, and concurrent reads need no lock.
    """

    __slots__ = ("n", "m", "version", "_host", "__weakref__")

    def __init__(self, dyn: "DynamicGraph"):
        self.n = dyn.n
        self.version = dyn.version
        self._host = dyn._host
        self.m = int(self._host.edge_keys.shape[0])

    @property
    def deg(self) -> np.ndarray:
        """Degrees int32[n] at the snapshot's version (read-only)."""
        return self._host.deg

    @property
    def edge_keys(self) -> np.ndarray:
        """Sorted canonical keys at the snapshot's version (read-only)."""
        return self._host.edge_keys

    def neighbors(self, v: int) -> np.ndarray:
        """Sorted neighbor ids of ``v`` at the snapshot's version."""
        return _neighbors(self.n, self._host.dir_keys, v)


class DynamicGraph:
    """Mutable undirected graph on a fixed vertex set with batched deltas.

    Mutations are single-writer (a :class:`~repro_torch.stream.session.
    StreamSession` serializes them under its mutation lock); readers take
    published generations by reference.
    """

    def __init__(self, n: int, edge_keys: np.ndarray, deg: np.ndarray,
                 dir_keys: np.ndarray, version: int = 0,
                 device: DeviceLike = DEFAULT_DEVICE):
        self.n = int(n)
        self.torch_device = resolve_device(device)
        self._host = _host_state(np.array(edge_keys, np.int64),
                                 np.array(deg, np.int32),
                                 np.array(dir_keys, np.int64))
        self.version = int(version)
        self.traffic = TrafficMeter(self.torch_device)
        self._device: Optional[DeviceGraphState] = None
        self._snapshots: "weakref.WeakSet[HostGraphSnapshot]" = \
            weakref.WeakSet()
        # a StreamSession installs its lease-aware report here; a bare
        # DynamicGraph falls back to "any live snapshot vetoes"
        self._donation_guard = None

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def from_edges(cls, n: int, edges,
                   device: DeviceLike = DEFAULT_DEVICE) -> "DynamicGraph":
        """Build from a raw edge array (duplicates/self-loops dropped); the
        keys are sorted on ``device`` (``from_edge_array``)."""
        return cls.from_graph(from_edge_array(n, edges, device=device))

    @classmethod
    def from_graph(cls, graph: Graph,
                   device: Optional[DeviceLike] = None) -> "DynamicGraph":
        """Build from a frozen :class:`~repro_torch.core.graph.Graph` (on
        the graph's device unless ``device`` is given): its edges and CSR
        are in key order already, so the host arrays need no sort."""
        graph = graph if device is None else graph.to(device)
        n = graph.n
        e = graph.edges.to(torch.int64)
        src = torch.repeat_interleave(
            torch.arange(n, device=graph.device), graph.deg.to(torch.int64))
        return cls(n, (e[:, 0] * n + e[:, 1]).cpu().numpy(),
                   graph.deg.cpu().numpy(),
                   (src * n + graph.indices.to(torch.int64)).cpu().numpy(),
                   device=graph.device)

    @classmethod
    def from_keys(cls, n: int, edge_keys: np.ndarray, deg: np.ndarray,
                  device: DeviceLike = DEFAULT_DEVICE) -> "DynamicGraph":
        """Build from sorted canonical keys and their degrees (a checkpoint's
        state): the directed keys are derived by one sort on ``device``,
        and the device mirror from them on first use, as a delta derives
        them."""
        dev = resolve_device(device)
        keys = np.asarray(edge_keys, dtype=np.int64)
        span = max(int(n), 1)
        k = torch.from_numpy(keys.copy()).to(dev)
        lo, hi = k // span, k % span
        dir_keys = torch.sort(torch.cat([k, hi * n + lo])).values
        return cls(n, keys, np.asarray(deg, dtype=np.int32),
                   dir_keys.cpu().numpy(), device=dev)

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------

    @property
    def edge_keys(self) -> np.ndarray:
        """Sorted canonical keys ``lo·n + hi`` int64[m] (read-only)."""
        return self._host.edge_keys

    @property
    def deg(self) -> np.ndarray:
        """Degrees int32[n] (read-only)."""
        return self._host.deg

    @property
    def d_max(self) -> int:
        """Maximum degree, at least 1 (the static graph's ``d_max``)."""
        return self._host.d_max

    @property
    def m(self) -> int:
        """Current number of (canonical, undirected) edges."""
        return int(self._host.edge_keys.shape[0])

    def neighbors(self, v: int) -> np.ndarray:
        """Sorted neighbor ids of ``v`` (host view, int32)."""
        return _neighbors(self.n, self._host.dir_keys, v)

    def edge_array(self) -> np.ndarray:
        """int64[m, 2] canonical (u < v) edges in key order."""
        return _decode_keys(self.n, self._host.edge_keys)

    @property
    def pinned(self) -> bool:
        """True while any live :class:`HostGraphSnapshot` pins published
        state."""
        return len(self._snapshots) > 0

    def snapshots(self) -> Tuple[HostGraphSnapshot, ...]:
        """The currently live (weakly tracked) host snapshots."""
        return tuple(self._snapshots)

    def donate_ok(self) -> bool:
        """Would an in-place update of the published device tensors be safe?

        A report, not a switch: every device generation is built out of
        place, so correctness never depends on it. A
        :class:`~repro_torch.stream.session.StreamSession` installs a guard
        that tracks serving read-leases and stale views; without one, any
        live host snapshot vetoes.
        """
        if self._donation_guard is not None:
            return bool(self._donation_guard())
        return not self.pinned

    def host_snapshot(self) -> HostGraphSnapshot:
        """Capture a frozen host view of the current version (tracked by
        weak reference)."""
        snap = HostGraphSnapshot(self)
        self._snapshots.add(snap)
        return snap

    @property
    def device(self) -> DeviceGraphState:
        """The device-resident mirror, created (one full upload) on first use
        and kept current by every subsequent ``apply_delta``."""
        if self._device is None:
            self._device = DeviceGraphState(self, self.traffic)
        return self._device

    def view(self) -> Graph:
        """``Graph`` over the live device buffers — the streaming hot path's
        graph, built with zero host → device traffic and no copy.

        Array-identical to ``snapshot()``; the next ``apply_delta``
        supersedes it, so sessions repoint at a fresh view per delta
        (``StreamSession`` does).
        """
        buf = self.device._buf             # one read: a concurrent publish
        return graph_view(self.n, buf.m, buf.deg,   # must not mix generations
                          buf.edges[:buf.m], buf.indptr, buf.indices,
                          buf.d_max)

    def snapshot(self) -> Graph:
        """Explicit full host materialization: a ``Graph`` on the graph's
        device that is array-identical to ``from_edge_array(n,
        self.edge_array())``. The streaming hot path never calls this."""
        host = self._host
        n = self.n
        indptr = np.zeros(n + 1, dtype=np.int32)
        np.cumsum(host.deg, out=indptr[1:])
        dev = self.torch_device

        def t(arr):
            return torch.from_numpy(np.array(arr, copy=True)).to(dev)

        return Graph(indptr=t(indptr),
                     indices=t((host.dir_keys % max(n, 1)).astype(np.int32)),
                     deg=t(host.deg),
                     edges=t(self.edge_array().astype(np.int32)),
                     n_vertices=n, n_edges=self.m, d_max=host.d_max)

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------

    def apply_delta(self, inserts=None, deletes=None) -> DeltaResult:
        """Apply one batch of edge insertions and deletions.

        Both arguments are (possibly duplicated / both-direction / already
        present or absent) edge arrays; the applied delta is canonicalized:
        deletes that miss and inserts that already exist are dropped.
        Deletes are applied before inserts, so an edge listed in both ends
        up present (and both endpoints count as dirty).
        """
        with trace.span("graph.apply_delta") as sp:
            delta = self._apply_delta(inserts, deletes)
            sp.set(inserted=int(delta.inserted.shape[0]),
                   deleted=int(delta.deleted.shape[0]),
                   touched=int(delta.touched.size), version=delta.version)
            return delta

    def _apply_delta(self, inserts, deletes) -> DeltaResult:
        """The untraced body of :meth:`apply_delta`."""
        n = self.n
        host = self._host
        cur = host.edge_keys
        with trace.span("graph.host_delta"):
            # the reference's set algebra over the sorted keys, as it is
            with trace.span("graph.host_isin"):
                del_req = canonical_edge_keys(n, deletes, "cpu").numpy()
                del_applied = del_req[np.isin(del_req, cur,
                                              assume_unique=True)]
                kept = (cur[~np.isin(cur, del_applied, assume_unique=True)]
                        if del_applied.size else cur)
                ins_req = canonical_edge_keys(n, inserts, "cpu").numpy()
                ins_applied = (ins_req[~np.isin(ins_req, kept,
                                                assume_unique=True)]
                               if ins_req.size else ins_req)

            ins_uv = _decode_keys(n, ins_applied)
            del_uv = _decode_keys(n, del_applied)
            self.version += 1
            if ins_applied.size == 0 and del_applied.size == 0:
                return DeltaResult(ins_uv, del_uv, np.zeros(0, np.int64),
                                   np.zeros(0, np.int64), self.version)

            with trace.span("graph.host_union"):
                # positions of the deleted edges in the *old* canonical
                # order — the device splice sentinels these before the
                # order changes
                del_pos = np.searchsorted(cur, del_applied).astype(np.int64)
                m_old = int(cur.shape[0])
                new_keys = np.union1d(kept, ins_applied)
                touched = np.unique(np.concatenate([ins_uv.ravel(),
                                                    del_uv.ravel()]))
                dirty = np.unique(del_uv.ravel())
            with trace.span("graph.host_directed"):
                new_deg = host.deg.astype(np.int64)
                if ins_uv.size:
                    new_deg += np.bincount(ins_uv.ravel(), minlength=n)
                if del_uv.size:
                    new_deg -= np.bincount(del_uv.ravel(), minlength=n)
                dir_keys = host.dir_keys
                if del_uv.size:
                    gone = np.sort(_directed(n, del_uv))
                    dir_keys = np.delete(dir_keys,
                                         np.searchsorted(dir_keys, gone))
                if ins_uv.size:
                    new = np.sort(_directed(n, ins_uv))
                    dir_keys = np.insert(dir_keys,
                                         np.searchsorted(dir_keys, new), new)
                # publication of the host generation: one rebind
                self._host = _host_state(new_keys, new_deg.astype(np.int32),
                                         dir_keys)
        delta = DeltaResult(ins_uv, del_uv, touched, dirty, self.version)
        if self._device is not None:
            self._device.apply_delta(self, delta, del_pos, m_old)
        return delta


# ----------------------------------------------------------------------------
# host helpers
# ----------------------------------------------------------------------------

def _decode_keys(n: int, keys: np.ndarray) -> np.ndarray:
    if keys.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    return np.stack([keys // n, keys % n], axis=1)


def _directed(n: int, uv: np.ndarray) -> np.ndarray:
    """Directed keys ``src·n + dst`` of both directions of edges ``uv``."""
    return np.concatenate([uv[:, 0] * n + uv[:, 1], uv[:, 1] * n + uv[:, 0]])
