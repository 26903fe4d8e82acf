"""Streaming mining session: DynamicGraph + sketch maintenance + engine.

A :class:`StreamSession` is the long-lived counterpart of the batch
``engine.MiningSession``: it owns a mutable :class:`DynamicGraph`, keeps one
sketch current through :class:`SketchMaintainer`, and holds a MiningSession
whose per-edge cardinality cache is *delta-aware* — after ``apply_delta``
only cardinalities of edges incident to touched (or policy-rebuilt) vertices
are recomputed; everything else is carried over by index. Under the strict
(default) error-budget policy every answer is bit-identical to a
from-scratch ``engine.session`` on the equivalent static graph.

The delta path is *device-resident*: the session serves queries from
``DynamicGraph.view()`` (a Graph over persistent device buffers) and every
per-delta upload — deleted positions, inserted edges, touched degrees,
sketch-insert entries, rebuilt row ids, the invalidated vertex ids — is
sized by the delta, never by the graph (``stats()["traffic"]`` reports the
exact bytes).

Publication: each mutation builds the next generation out of place (new
device tensors, a forked engine session) and publishes it with one
attribute swap, so a flush holding the previous :class:`ServingView` is
never torn.

Checkpoints (``save``/``restore``) go through ``checkpoint.store`` in the
reference's format, without the reference's ``adj`` leaf and ``headroom``
setting (the port has neither): the edge keys, degrees, sketch and the
dirty/stale bookkeeping. ``restore`` also reads a checkpoint written by the
reference's session and ignores its ``adj``.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Optional

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, DeviceLike
from ..checkpoint import store
from ..core.sketches import SketchSet, bloom_membership
from ..engine.api import (DeviceCarry, EnginePlan, MiningSession,
                          resolve_plan)
from ..obs import accuracy, trace
from .dynamic_graph import DynamicGraph, HostGraphSnapshot
from .maintenance import ErrorBudgetPolicy, SketchMaintainer


def _membership(sk: Optional[SketchSet], host: HostGraphSnapshot, u: int,
                candidates, device) -> torch.Tensor:
    """Is each candidate a neighbor of u? BF answers from the sketch row
    (the paper's membership primitive); other kinds answer exactly."""
    cand = np.asarray(candidates, dtype=np.int32)
    if sk is not None and sk.kind == "bf":
        return bloom_membership(sk.data[int(u)],
                                torch.from_numpy(cand.copy()).to(device),
                                host.n, sk.num_hashes, sk.total_bits, sk.seed)
    return torch.from_numpy(np.isin(cand, host.neighbors(u))).to(device)


@dataclasses.dataclass(frozen=True)
class ServingView:
    """One published, snapshot-isolated serving generation.

    Everything a flush needs to answer queries at a single consistent
    version: the engine session (graph view + sketch + per-edge cardinality
    cache, all rebound-only state), the sketch, and a host graph snapshot
    for the few host-side reads (link-prediction candidates, local-cluster
    volume accounting). ``apply_delta`` builds the *next* view off to the
    side and publishes it with one attribute swap, so an in-flight flush
    that captured this view keeps serving version N bit-identically while
    version N+1 lands.

    ``epoch`` is the publication sequence number — unlike ``version`` it
    also advances on maintenance rebuilds (which change sketch rows without
    an edge delta), which is what the result cache's stale-put guard keys
    on.
    """

    version: int
    epoch: int
    session: MiningSession
    sketch: Optional[SketchSet]
    host: HostGraphSnapshot

    def membership(self, u: int, candidates) -> torch.Tensor:
        """Membership tests at this view's version — the snapshot twin of
        ``StreamSession.membership``."""
        return _membership(self.sketch, self.host, u, candidates,
                           self.session.graph.device)


class StreamSession:
    """Interleaved mutation + query serving over one maintained sketch."""

    # machine-checked lock discipline (tools/pgcheck PG001). `write:` specs
    # are the snapshot-isolation contract: `_serving`, `session` and
    # `version` are atomic published references — readers never lock, and
    # only mutators (all of which hold `_mutate_lock`) may swap them. The
    # lease count lives under `_lease_lock`.
    _GUARDED_BY = {
        "_serving": "write:_mutate_lock",
        "session": "write:_mutate_lock",
        "version": "write:_mutate_lock",
        "_delta_listeners": "_mutate_lock",
        "_read_leases": "_lease_lock",
    }

    def __init__(self, dyn: DynamicGraph, kind: Optional[str] = "bf",
                 storage_budget: float = 0.25, num_hashes: int = 2,
                 seed: int = 0, words: Optional[int] = None,
                 k: Optional[int] = None,
                 policy: Optional[ErrorBudgetPolicy] = None,
                 plan: Optional[EnginePlan] = None,
                 sketch_data: Optional[torch.Tensor] = None, **plan_kw):
        self.dyn = dyn
        graph = dyn.view()                 # device-resident; no host snapshot
        # the mirror exists now, so the initial sketch build reads the
        # device CSR directly instead of uploading anything a second time
        self.maintainer = None if kind is None else SketchMaintainer(
            dyn, kind, storage_budget=storage_budget, num_hashes=num_hashes,
            seed=seed, words=words, k=k, policy=policy, data=sketch_data)
        sketch = self.maintainer.sketch if self.maintainer else None
        self.session = MiningSession(
            graph, sketch, resolve_plan(plan, graph, sketch, plan_kw))
        self.version = 0
        self.cards_recomputed = 0
        self.cards_carried = 0
        self.extra = {}            # restore() fills this from the checkpoint
        self._delta_listeners = []  # serving-tier invalidation subscribers
        # the session's metric home: the traffic meter's registry, so one
        # snapshot carries upload accounting plus anything recorded here
        self.metrics = dyn.traffic.registry
        # snapshot-isolated serving: mutations serialize on this lock and
        # end by publishing a fresh ServingView; readers never block and
        # never see a half-applied delta
        self._mutate_lock = threading.RLock()
        self._serving = ServingView(0, 0, self.session, sketch,
                                    dyn.host_snapshot())
        # read leases: flushes count themselves in and out, so
        # `donate_ok` can report whether anyone reads the published
        # generation (every generation is built out of place, so the
        # report never decides correctness)
        self._lease_lock = threading.Lock()
        self._read_leases = 0
        dyn._donation_guard = self._device_donate_ok

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------

    @property
    def graph(self):
        """The Graph the engine session currently serves (a device view)."""
        return self.session.graph

    @property
    def sketch(self) -> Optional[SketchSet]:
        """The maintained sketch, or None in exact mode."""
        return self.maintainer.sketch if self.maintainer else None

    def serving_view(self) -> ServingView:
        """The currently published :class:`ServingView` (atomic read).

        Flushes capture this once and serve everything from it — a delta
        landing mid-flush builds and publishes the *next* view without
        disturbing the captured one.
        """
        return self._serving

    def acquire_serving_view(self) -> ServingView:
        """Capture the published view under a read lease (pair with
        :meth:`release_serving_view`). The lease count is what
        ``dyn.donate_ok()`` reports on."""
        with self._lease_lock:
            self._read_leases += 1
            return self._serving

    def release_serving_view(self, view: Optional[ServingView] = None) -> None:
        """Release one :meth:`acquire_serving_view` lease (``view`` is
        accepted for call-site symmetry; leases are a plain count)."""
        with self._lease_lock:
            self._read_leases = max(self._read_leases - 1, 0)

    def _device_donate_ok(self) -> bool:
        """Donation report installed on ``dyn`` (see ``donate_ok``): an
        in-place update of the published device tensors would be safe only
        when no serving lease is out and no host snapshot other than the
        published view's own is alive (a stale view still in flight keeps
        its snapshot alive)."""
        with self._lease_lock:
            if self._read_leases:
                return False
        published = self._serving.host
        return all(s is published for s in self.dyn.snapshots())

    def add_delta_listener(self, fn) -> None:
        """Subscribe ``fn(vertices, epoch)`` to the invalidation feed.

        After every delta (and every maintenance :meth:`flush` that rebuilt
        rows) each listener is called with the sorted int64 vertex set whose
        adjacency, degree, or sketch row changed — ``touched ∪ rebuilt`` —
        and the publication epoch of the change. This is exactly the set a
        serving-tier result cache must evict footprint-intersecting entries
        for. Listeners fire *before* the new :class:`ServingView` publishes,
        so by the time any flush can read the new version its cache is
        already clean.
        """
        with self._mutate_lock:
            self._delta_listeners.append(fn)

    def remove_delta_listener(self, fn) -> None:
        """Unsubscribe a listener previously added (no-op if absent)."""
        with self._mutate_lock:
            if fn in self._delta_listeners:
                self._delta_listeners.remove(fn)

    def _publish_invalid_locked(self, vertices: np.ndarray,
                                epoch: int) -> None:
        """Push one delta's changed-vertex set to every listener (a copy of
        the list: a listener may unsubscribe itself mid-publish). Callers
        hold ``_mutate_lock``."""
        if vertices.size:
            for fn in list(self._delta_listeners):
                fn(vertices, epoch)

    def _publish_view_locked(self) -> None:
        """Publish the post-mutation state as the serving view (callers
        hold ``_mutate_lock`` and have already fired the invalidation
        feed)."""
        self._serving = ServingView(
            self.version, self._serving.epoch + 1, self.session,
            self.maintainer.sketch if self.maintainer else None,
            self.dyn.host_snapshot())

    def _device_carry(self, invalid: np.ndarray,
                      identity: bool) -> DeviceCarry:
        """Assemble the device-resident refresh carry.

        The splice permutation already lives on the device, and so do the
        edges: an edge's cardinality is recomputed when it is new (carry <
        0) or an endpoint is in ``invalid`` (touched ∪ rebuilt), which only
        the vertex ids need to cross the bus for. (Uploading the positions
        instead, as the reference does, costs 4 bytes per edge incident to
        a touched vertex: most of the graph when hubs are touched.)"""
        dev = self.dyn.device
        base = dev.identity_carry() if identity else dev.last_carry
        with trace.span("stream.recompute_set",
                        invalid=int(invalid.size)) as sp:
            bad = torch.zeros(self.dyn.n + 1, dtype=torch.bool,
                              device=base.device)
            bad[self.dyn.traffic.put(invalid.astype(np.int32)).to(
                torch.int64)] = True
            edges = dev.edges[:dev.m].to(torch.int64)
            pos = torch.nonzero((base[:dev.m] < 0) | bad[edges[:, 0]]
                                | bad[edges[:, 1]])[:, 0]
            sp.set(recompute=int(pos.numel()))
        return DeviceCarry(base, pos, int(pos.numel()), dev.edges)

    def apply_delta(self, inserts=None, deletes=None) -> dict:
        """Apply one edge-delta batch: mutate the graph, maintain the sketch
        incrementally, and refresh only the invalidated session caches.

        Device-resident: no full-graph host copy or upload happens here —
        the returned ``bytes_uploaded`` (also in ``stats()["traffic"]``) is
        the exact host → device traffic, proportional to the delta size.
        """
        with trace.span("stream.apply_delta") as sp, self._mutate_lock:
            return self._apply_delta_locked(inserts, deletes, sp)

    def _apply_delta_locked(self, inserts, deletes, sp) -> dict:
        """The body of :meth:`apply_delta` (mutation lock held)."""
        self.dyn.traffic.begin_delta()
        delta = self.dyn.apply_delta(inserts, deletes)
        rebuilt = (self.maintainer.apply(delta)
                   if self.maintainer else np.zeros(0, np.int64))
        self.version += 1
        rec = car = 0
        if not (delta.is_noop and rebuilt.size == 0):
            self.dyn.traffic.commit_step()  # noop deltas stay unmetered
            graph = self.dyn.view()
            # a row rebuilt this delta may have gone dirty at an
            # *earlier* delta (policy deferral), so invalidation covers
            # touched ∪ rebuilt
            invalid = np.union1d(delta.touched, rebuilt)
            carry = self._device_carry(
                invalid, identity=delta.is_noop)  # a noop ran no splice
            # fork-refresh-publish: the live session keeps serving the
            # previous version while the fork absorbs the delta; the
            # swap below is the version-N+1 publication point
            new_session = self.session.fork()
            recomputed = new_session.refresh(
                graph,
                self.maintainer.sketch if self.maintainer else None,
                carry)
            # refresh returns None when it dropped the cache (nothing
            # carried; the full pass happens lazily) — no savings counted
            rec = 0 if recomputed is None else recomputed
            car = 0 if recomputed is None else max(graph.m - recomputed, 0)
            self.cards_recomputed += rec
            self.cards_carried += car
            # invalidation completes BEFORE publication: once a flush
            # can capture the new view, every stale cache entry is gone
            self._publish_invalid_locked(invalid, self._serving.epoch + 1)
            self.session = new_session
        self._publish_view_locked()
        if self.maintainer is not None:
            accuracy.record_maintenance(self.maintainer.stats(),
                                        self.metrics)
        info = {
            "version": self.version,
            "inserted": int(delta.inserted.shape[0]),
            "deleted": int(delta.deleted.shape[0]),
            "touched": int(delta.touched.shape[0]),
            "rows_rebuilt_now": int(rebuilt.size),
            "cards_recomputed": rec,
            "cards_carried": car,
            "bytes_uploaded": self.dyn.traffic.bytes_delta,
        }
        sp.set(**info)
        return info

    def flush(self) -> int:
        """Force-rebuild all dirty sketch rows and refresh their edges —
        makes subsequent answers exact w.r.t. the current graph even under a
        lazy error-budget policy."""
        if self.maintainer is None or not self.maintainer.dirty.any():
            return 0       # nothing to rebuild: not a metered traffic step
        with trace.span("stream.flush") as sp, self._mutate_lock:
            self.dyn.traffic.begin_delta()
            self.dyn.traffic.commit_step()
            rebuilt = self.maintainer.flush()
            if rebuilt.size:
                carry = self._device_carry(
                    rebuilt, identity=True)  # edge set unchanged by a flush
                new_session = self.session.fork()
                new_session.refresh(self.dyn.view(), self.maintainer.sketch,
                                    carry)
                # a rebuild replaces stale sketch rows: cached answers
                # reading those rows are now wrong, exactly like a delta
                # touching them
                self._publish_invalid_locked(rebuilt.astype(np.int64),
                                             self._serving.epoch + 1)
                self.session = new_session
                self._publish_view_locked()
            sp.set(rows_rebuilt=int(rebuilt.size))
        return int(rebuilt.size)

    # ------------------------------------------------------------------
    # queries (the batch engine's surface, served on the live graph)
    # ------------------------------------------------------------------

    def triangle_count(self) -> torch.Tensor:
        """Scalar TC estimate over the live graph (shared engine pass)."""
        return self.session.triangle_count()

    def local_clustering(self) -> torch.Tensor:
        """Per-vertex clustering coefficients float32[n] (live graph)."""
        return self.session.local_clustering()

    def four_clique_count(self) -> torch.Tensor:
        """Scalar 4-clique count estimate over the live graph."""
        return self.session.four_clique_count()

    def five_clique_count(self) -> torch.Tensor:
        """Scalar 5-clique count estimate over the live graph."""
        return self.session.five_clique_count()

    def similarity(self, pairs, measure: str = "jaccard") -> torch.Tensor:
        """Similarity scores float32[P] for vertex pairs on the live graph."""
        pairs = torch.as_tensor(np.asarray(pairs, dtype=np.int32).reshape(
            -1, 2)).to(self.dyn.torch_device)
        return self.session.similarity(pairs, measure)

    def local_cluster(self, seeds, alpha: float = 0.15, eps: float = 1e-4,
                      **kw):
        """Seed-centric local clustering on the live graph (see
        :meth:`repro_torch.engine.engine.MiningSession.local_cluster`);
        under the strict policy bit-identical to a fresh static session."""
        return self.session.local_cluster(seeds, alpha, eps, **kw)

    def membership(self, u: int, candidates) -> torch.Tensor:
        """Is each candidate a neighbor of u? BF answers from the sketch row
        (the paper's membership primitive); other kinds answer exactly."""
        return _membership(self.sketch, self.dyn, u, candidates,
                           self.dyn.torch_device)

    def stats(self) -> dict:
        """Session counters: sizes, cache savings, traffic, maintenance."""
        out = {
            "version": self.version,
            "n": self.dyn.n, "m": self.dyn.m,
            "cards_recomputed": self.cards_recomputed,
            "cards_carried": self.cards_carried,
            # host → device bytes: init is the one-time residency upload;
            # bytes_per_delta_mean is the per-delta traffic the
            # device-resident design bounds by the delta size
            "traffic": self.dyn.traffic.stats(),
        }
        if self.maintainer is not None:
            out["maintenance"] = self.maintainer.stats()
            # accuracy telemetry: sketch saturation is the leading indicator
            # of estimate inflation (stats-time, not hot path)
            accuracy.record_fill(self.maintainer.sketch, self.metrics)
        return out

    # ------------------------------------------------------------------
    # snapshot / restore
    # ------------------------------------------------------------------

    def _config(self, extra: Optional[dict] = None) -> dict:
        cfg = {"kind": None, "extra": extra or {}}
        if self.maintainer is not None:
            mt = self.maintainer
            cfg.update(kind=mt.kind, num_hashes=mt.num_hashes, seed=mt.seed,
                       words=mt.words, k=mt.k,
                       policy={"rel_tolerance": mt.policy.rel_tolerance,
                               "confidence": mt.policy.confidence,
                               "max_stale": mt.policy.max_stale})
        return cfg

    def save(self, directory: str, step: Optional[int] = None,
             keep: int = 3, extra: Optional[dict] = None) -> str:
        """Atomic snapshot of the dynamic state (edge keys, degrees, sketch
        and the dirty/stale bookkeeping) via checkpoint.store. ``extra``
        is a JSON-able dict the caller can check at restore time (e.g. the
        replay launcher's stream parameters)."""
        step = self.version if step is None else int(step)
        # hold the mutation lock: a delta landing mid-save must not tear the
        # checkpoint across versions (sketch from N+1, edge_keys from N)
        with self._mutate_lock:
            return self._save_locked(directory, step, keep, extra)

    def _save_locked(self, directory: str, step: int, keep: int,
                     extra: Optional[dict]) -> str:
        tree = {
            "config": np.frombuffer(
                json.dumps(self._config(extra)).encode(),
                dtype=np.uint8).copy(),
            "n": np.int64(self.dyn.n),
            "version": np.int64(self.version),
            "edge_keys": self.dyn.edge_keys,
            "deg": self.dyn.deg,
        }
        if self.maintainer is not None:
            mt = self.maintainer
            sketch = mt.sketch.data.cpu().numpy()
            if mt.kind == "bf":          # the reference's uint32 words
                sketch = sketch.view(np.uint32)
            tree.update(sketch=sketch, dirty=mt.dirty, stale=mt.stale,
                        counters=np.asarray([mt.rows_incremental,
                                             mt.rows_rebuilt,
                                             mt.deltas_applied], np.int64))
        return store.save_checkpoint(directory, step, tree, keep=keep)

    @classmethod
    def restore(cls, directory: str, step: Optional[int] = None,
                plan: Optional[EnginePlan] = None,
                device: DeviceLike = DEFAULT_DEVICE,
                **plan_kw) -> "StreamSession":
        """Resume a session on ``device`` from a :meth:`save` checkpoint
        (latest step by default) or one the reference's session wrote.

        The graph is rebuilt from the stored edge keys and degrees (its
        directed keys and device CSR derived, as a delta derives them),
        the sketch is taken as stored, not rebuilt, and the stored config
        re-creates the policy. A reference checkpoint's ``adj`` leaf is
        never read."""
        if step is None:
            step = store.latest_step(directory)
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {directory}")
        meta = store.load_meta(directory, step)
        target = {key: torch.empty(leaf["shape"],
                                   dtype=store.torch_dtype(leaf["dtype"]),
                                   device="meta")
                  for key, leaf in meta["leaves"].items() if key != "adj"}
        tree = store.restore_checkpoint(directory, step, target,
                                        device="cpu")
        cfg = json.loads(tree["config"].numpy().tobytes().decode())
        dyn = DynamicGraph.from_keys(int(tree["n"]),
                                     tree["edge_keys"].numpy(),
                                     tree["deg"].numpy(), device=device)
        sketch_data = None
        if cfg["kind"]:
            raw = tree["sketch"].numpy()
            if raw.dtype == np.uint32:     # Bloom words as int32 patterns
                raw = raw.view(np.int32)
            sketch_data = torch.from_numpy(raw.copy()).to(dyn.torch_device)
        policy = (ErrorBudgetPolicy(**cfg["policy"])
                  if cfg.get("policy") else None)
        self = cls(dyn, kind=cfg["kind"], num_hashes=cfg.get("num_hashes", 2),
                   seed=cfg.get("seed", 0), words=cfg.get("words") or None,
                   k=cfg.get("k") or None, policy=policy, plan=plan,
                   sketch_data=sketch_data, **plan_kw)
        # the restored session is not shared yet, but version/view swaps
        # are mutations all the same: hold the lock like every mutator
        with self._mutate_lock:
            self.version = int(tree["version"])
            self.extra = cfg.get("extra") or {}
            if self.maintainer is not None:
                mt = self.maintainer
                mt.dirty = tree["dirty"].numpy().astype(bool)
                mt.stale = tree["stale"].numpy().astype(np.int64)
                mt.rows_incremental, mt.rows_rebuilt, mt.deltas_applied = (
                    int(x) for x in tree["counters"])
            # __init__ published a view stamped version 0; re-publish so
            # the serving view carries the restored version
            self._publish_view_locked()
        return self


def stream_session(graph_or_dyn, kind: Optional[str] = "bf",
                   **kwargs) -> StreamSession:
    """Open a streaming session over a Graph or DynamicGraph (the streaming
    twin of ``engine.session``); a Graph's dynamic twin lives on the
    graph's device."""
    dyn = (graph_or_dyn if isinstance(graph_or_dyn, DynamicGraph)
           else DynamicGraph.from_graph(graph_or_dyn))
    return StreamSession(dyn, kind=kind, **kwargs)
