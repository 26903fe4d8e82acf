"""Batched query serving over a live StreamSession, with a result cache.

Requests (similarity / link-prediction / membership / triangle-count /
local clustering) accumulate in a queue; ``flush()`` groups them, pads each
group to fixed batch shapes (powers of two, as the reference does, so the
padding counters of ``stats()`` mean the same), and answers everything
through the engine seam —
one ``pair_cardinality_fn`` evaluation serves *all* pair-scored requests in
a flush, whatever similarity measure each asked for, because every measure
derives from |N_u ∩ N_v| + degrees (``similarity_from_cardinalities``).

Serving-tier layers riding on top of the batching:

* **Snapshot isolation**: every flush captures one published
  :class:`~repro_torch.stream.session.ServingView` and answers everything from
  it, so queries run concurrently with delta application — a delta landing
  mid-flush builds and publishes version N+1 while the flush keeps serving
  a consistent version N. Each answer's ``answered_version`` names the
  snapshot it was computed at.
* **Result cache** (:class:`repro_torch.stream.cache.ResultCache`, on by
  default): answers are keyed by ``(kind, canonical args)`` and carry the
  exact vertex :class:`~repro_torch.engine.Footprint` they were computed
  from;
  the session's delta feed (``touched ∪ rebuilt``) evicts precisely the
  intersecting entries, so a hit is — under the strict error-budget
  policy — bit-identical to recomputing on the live graph.
* **Coalescing**: identical pending requests in one flush compute once and
  fan out to every request id; duplicate local-cluster seeds in one
  ``(alpha, eps)`` group collapse the same way (the canonical key *is* the
  dedup unit).
* **Admission policy**: optional ``max_batch`` (auto-flush when the queue
  fills) and ``max_wait_s`` (``poll()`` flushes once the oldest pending
  request has waited long enough), extended per tenant: every submit may
  carry ``tenant=`` and ``deadline_s=``, a ``tenant_quota`` sheds
  over-quota submits with :class:`OverloadError` (counted per tenant), and
  flushes serve requests earliest-deadline-first.
* **Background flush worker** (``async_flush=True``): a daemon thread
  applies the admission policy — flushing on ``max_batch``, ``max_wait_s``
  and deadline pressure — so submitters never pay flush latency inline and
  delta application overlaps query service. ``flush()``/``poll()``/
  ``drain()`` keep their contracts (flush bodies are serialized either
  way).

Each response carries per-query latency (submit → answer wall time) and
staleness (graph deltas applied between submit and answer) so a serving tier
above this can reason about freshness.

On a CUDA session the pair batch runs the AND2 gather popcount (Bloom) or
the MinHash gather count (k-Hash, 1-Hash naive) and the local-cluster sweep
the dense AND2 popcount; nothing here catches a kernel failure.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.algorithms.similarity import similarity_from_cardinalities
from ..engine import api as eng
from ..engine.api import Footprint, pow2_bucket
from ..obs import accuracy, trace
from ..obs.metrics import MetricsRegistry
from .cache import ResultCache
from .session import StreamSession


class OverloadError(RuntimeError):
    """A submit was shed because its tenant's pending quota is exhausted.

    Raised synchronously by ``submit_*``; the shed is counted in
    ``server_shed_total{tenant=...}`` so overload accounting survives even
    when callers swallow the exception.
    """


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """One answered request: value plus latency/staleness provenance."""

    request_id: int
    kind: str
    value: object
    submitted_version: int
    answered_version: int
    latency_s: float
    tenant: str = "default"
    deadline_missed: bool = False

    @property
    def staleness(self) -> int:
        """Graph deltas applied between submit and answer (0 == fresh)."""
        return self.answered_version - self.submitted_version


@dataclasses.dataclass
class _Pending:
    request_id: int
    kind: str   # similarity | linkpred | membership | tc | cliques | localcluster
    key: Tuple         # canonical (kind, args…) — the cache/coalescing unit
    measure: str
    pairs: Optional[np.ndarray]     # [P, 2] for similarity requests
    payload: dict
    submitted_version: int
    t_submit: float
    tenant: str = "default"
    deadline: Optional[float] = None   # absolute perf_counter() SLO deadline


def _edf_key(p: _Pending) -> Tuple[float, int]:
    # earliest-deadline-first, submission order among the deadline-free
    return (p.deadline if p.deadline is not None else math.inf, p.request_id)


def _freeze(value):
    """Recursively mark an answer's arrays read-only before caching/sharing.

    Deep, not shallow: hits and coalesced duplicates share the whole object
    graph, so a writable array nested anywhere (a list of arrays, a dict
    inside a dict) would let one caller poison every later reader of the
    same key.
    """
    if isinstance(value, np.ndarray):
        value.setflags(write=False)
    elif isinstance(value, dict):
        for item in value.values():
            _freeze(item)
    elif isinstance(value, (list, tuple)):
        for item in value:
            _freeze(item)
    return value


class BatchedQueryServer:
    """Accumulate-and-flush query server over one StreamSession.

    Args:
      stream:         the live session to serve from.
      min_batch:      pow2 padding floor shared by the pair, membership and
                      local-cluster seed batches.
      stats_window:   bounded latency/staleness window size.
      cache:          keep a footprint-invalidated result cache (default on;
                      answers stay bit-identical — see ``stream.cache``).
      cache_capacity: LRU entry bound for the cache.
      max_batch:      auto-flush as soon as this many requests are pending
                      (None = only explicit ``flush()``/``poll()``).
      max_wait_s:     ``poll()`` (or the async worker) flushes once the
                      oldest pending request has waited this long (None =
                      never due by age).
      async_flush:    run a background worker thread that applies the
                      admission policy (max_batch / max_wait_s / deadline
                      pressure), so submits return immediately and flushes
                      overlap delta application.
      tenant_quota:   per-tenant pending-request bound; submits beyond it
                      raise :class:`OverloadError` (None = unbounded).
      max_backlog:    async-mode high-water mark: a submit that finds this
                      many requests already queued blocks until the worker
                      drains below it (defaults to ``4 * max_batch``, or
                      256 when ``max_batch`` is None). A hot submitting
                      thread would otherwise outrun — and, through the GIL
                      plus lock convoy, starve — the worker, growing the
                      queue without bound so every answer lands at the
                      final drain. A full backlog is itself a flush trigger
                      for the worker, so submits can never block forever
                      even with no other admission policy configured.
    """

    # machine-checked lock discipline (tools/pgcheck PG001): these fields
    # may only be touched under the named lock(s) — `_cond` wraps `_lock`,
    # so holding either is holding the same mutex. `write:` specs leave
    # reads free: `cache` is an atomic published reference (flushes alias
    # it once and run on the alias), matching the serving-view pattern.
    _GUARDED_BY = {
        "_queue": "_lock|_cond",
        "_results": "_lock|_cond",
        "_next_id": "_lock|_cond",
        "_pending_tenant": "_lock|_cond",
        "_closed": "_lock|_cond",
        "_pad": "_lock|_cond",
        "_service_ewma": "_lock|_cond",
        "_listener": "_lock|_cond",
        "cache": "write:_lock|_cond",
    }

    # machine-checked footprint coverage (tools/pgcheck PG005, invariant 7):
    # every query kind this server submits must declare how its cached
    # answers are invalidated — an exact Footprint built in the flush path,
    # or a whole-graph marker (any delta invalidates).
    _KIND_FOOTPRINTS = {
        "similarity": "exact",
        "linkpred": "exact",
        "membership": "exact",
        "localcluster": "exact",
        "tc": "whole_graph",
        "cliques": "whole_graph",
    }

    def __init__(self, stream: StreamSession, min_batch: int = 64,
                 stats_window: int = 65536, cache: bool = True,
                 cache_capacity: int = 4096,
                 max_batch: Optional[int] = None,
                 max_wait_s: Optional[float] = None,
                 async_flush: bool = False,
                 tenant_quota: Optional[int] = None,
                 max_backlog: Optional[int] = None):
        self.stream = stream
        self.min_batch = int(min_batch)
        self.max_batch = None if max_batch is None else int(max_batch)
        self.max_wait_s = None if max_wait_s is None else float(max_wait_s)
        self.max_backlog = (int(max_backlog) if max_backlog is not None
                            else 4 * self.max_batch if self.max_batch
                            else 256)
        self.tenant_quota = None if tenant_quota is None else int(tenant_quota)
        self.cache = ResultCache(cache_capacity) if cache else None
        self._listener = None
        if self.cache is not None:
            # weakref-bound listener: a dropped server must not pin its
            # cache via the session's listener list, nor keep charging
            # every future delta for invalidating a dead cache — the
            # closure self-unsubscribes once the cache is collected
            cache_ref = weakref.ref(self.cache)
            stream_ref = weakref.ref(stream)

            def _invalidate(vertices, epoch):
                target = cache_ref()
                if target is None:
                    sess = stream_ref()
                    if sess is not None:
                        sess.remove_delta_listener(_invalidate)
                    return
                target.invalidate(vertices, epoch)

            self._listener = _invalidate
            stream.add_delta_listener(_invalidate)
        self._queue: List[_Pending] = []
        self._results: Dict[int, QueryResult] = {}
        self._next_id = 0
        self._pending_tenant: Dict[str, int] = {}
        # _lock guards queue/results/counters; _cond wakes the worker and
        # flush() waiters; _flush_lock serializes flush *bodies* so two
        # flushes never interleave their snapshot reads and cache puts
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._flush_lock = threading.Lock()
        self._closed = False
        self._service_ewma = 0.0       # smoothed flush service time (s)
        self._stats_window = int(stats_window)
        # serving counters live in the per-server metrics registry;
        # ``stats()`` is a bit-compatible view over these instruments
        self.metrics = MetricsRegistry()
        self._c_served = self.metrics.counter("server_served_total")
        self._c_flushes = self.metrics.counter("server_flushes_total")
        self._c_coalesced = self.metrics.counter("server_coalesced_total")
        # bounded windows: a long-lived server must not grow per-query state
        self._h_latency = self.metrics.histogram("server_latency_s",
                                                 window=stats_window)
        self._h_staleness = self.metrics.histogram("server_staleness",
                                                   window=stats_window)
        # per-path (real, padded) row counters — membership and seed batches
        # pad very differently from the shared pair pass, so they are not
        # lumped into one overhead number; the plain dict stays the write
        # surface (tests poke it), mirrored into the registry by _pad_add
        self._pad = {"pairs": [0, 0], "membership": [0, 0],
                     "localcluster": [0, 0]}
        for name in self._pad:
            self.metrics.counter("server_pad_rows", path=name, rows="real")
            self.metrics.counter("server_pad_rows", path=name, rows="padded")
        self._worker: Optional[threading.Thread] = None
        if async_flush:
            self._worker = threading.Thread(target=self._worker_loop,
                                            name="server-flush-worker",
                                            daemon=True)
            self._worker.start()

    @property
    def _served(self) -> int:
        return self._c_served.value

    @property
    def _flushes(self) -> int:
        return self._c_flushes.value

    @property
    def _coalesced(self) -> int:
        return self._c_coalesced.value

    def _pad_add(self, name: str, real: int, padded: int) -> None:
        """Meter one padded batch: real vs padded row counts for ``name``.

        Called from flush bodies, which run under ``_flush_lock`` but *not*
        ``_lock`` — the `+=` through the shared dict needs the lock or a
        concurrent ``stats()`` read can observe a torn (real, padded) pair.
        """
        with self._lock:
            self._pad[name][0] += real
            self._pad[name][1] += padded
        self.metrics.counter("server_pad_rows", path=name,
                             rows="real").inc(real)
        self.metrics.counter("server_pad_rows", path=name,
                             rows="padded").inc(padded)

    def close(self) -> None:
        """Flush-then-detach shutdown: answer everything pending, stop the
        worker, leave the session's invalidation feed, and drop the cache.

        Every request submitted before ``close()`` is answered and stays
        claimable through :meth:`drain`; submits after ``close()`` raise.
        With ``async_flush`` the worker performs the final flush and is
        joined before this returns. The cache is dropped because a detached
        server can no longer keep it honest.
        """
        with self._cond:
            first = not self._closed
            self._closed = True
            self._cond.notify_all()
        if self._worker is not None:
            # the worker's exit path flushes whatever is still queued
            self._worker.join()
            self._worker = None
        elif first:
            self._flush_queue()        # answer stranded sync-mode requests
        # detach under the lock so a racing close() cannot double-remove the
        # listener; the session call itself runs outside it (the session
        # takes its own _mutate_lock — never nest the two)
        with self._lock:
            listener, self._listener = self._listener, None
            self.cache = None
        if listener is not None:
            self.stream.remove_delta_listener(listener)

    @property
    def closed(self) -> bool:
        """True once :meth:`close` has been called."""
        with self._lock:
            return self._closed

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def _submit(self, kind: str, key: Tuple, measure: str = "",
                pairs: Optional[np.ndarray] = None, *,
                tenant: str = "default",
                deadline_s: Optional[float] = None, **payload) -> int:
        t_now = time.perf_counter()
        deadline = None if deadline_s is None else t_now + float(deadline_s)
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    "BatchedQueryServer is closed; new submits are rejected "
                    "(close() answered everything submitted before it)")
            pending = self._pending_tenant.get(tenant, 0)
            if self.tenant_quota is not None and pending >= self.tenant_quota:
                self.metrics.counter("server_shed_total", tenant=tenant).inc()
                raise OverloadError(
                    f"tenant {tenant!r} has {pending} pending requests "
                    f"(quota {self.tenant_quota}); request shed")
            rid = self._next_id
            self._next_id += 1
            self._queue.append(_Pending(
                rid, kind, key, measure, pairs, payload,
                self.stream.serving_view().version, t_now, tenant, deadline))
            self._pending_tenant[tenant] = pending + 1
            due = (self.max_batch is not None
                   and len(self._queue) >= self.max_batch)
            if self._worker is not None:
                self._cond.notify_all()    # admission runs on the worker
                # backpressure: block until the worker drains below the
                # high-water mark — cond.wait releases _lock, so this is
                # also what hands the convoyed lock to the worker
                throttled = False
                while (len(self._queue) >= self.max_backlog
                       and not self._closed):
                    if not throttled:
                        self.metrics.counter(
                            "server_backpressure_total").inc()
                        throttled = True
                    self._cond.wait(0.05)
                return rid
        if due:
            self._flush_queue()
        return rid

    def submit_similarity(self, pairs, measure: str = "jaccard", *,
                          tenant: str = "default",
                          deadline_s: Optional[float] = None) -> int:
        """Score vertex pairs [P, 2] under any cardinality-derived measure."""
        # copy, not view: the key snapshots the bytes here, and the flush
        # computes from this array — a caller reusing its buffer must not
        # be able to poison the cache with a key/value mismatch
        pairs = np.array(pairs, dtype=np.int32, copy=True).reshape(-1, 2)
        key = ("similarity", measure, pairs.shape[0], pairs.tobytes())
        return self._submit("similarity", key, measure, pairs,
                            tenant=tenant, deadline_s=deadline_s)

    def submit_link_prediction(self, u: int, top_k: int = 8,
                               measure: str = "common", *,
                               tenant: str = "default",
                               deadline_s: Optional[float] = None) -> int:
        """Top-k predicted partners for u among its distance-2 non-neighbors
        (Listing-5 candidates, served online).

        The candidate set is materialized from the flush's serving snapshot,
        not here: with deltas interleaved between submit and flush, a
        submit-time candidate set would mix stale candidates (e.g. a vertex
        that became a neighbor still "predicted") with fresh scores.
        """
        key = ("linkpred", measure, int(u), int(top_k))
        return self._submit("linkpred", key, measure, u=int(u),
                            top_k=int(top_k), tenant=tenant,
                            deadline_s=deadline_s)

    def submit_membership(self, u: int, candidates, *,
                          tenant: str = "default",
                          deadline_s: Optional[float] = None) -> int:
        """x ∈ N_u membership tests (BF answers straight from the sketch)."""
        cand = np.array(candidates, dtype=np.int32, copy=True)  # see above
        key = ("membership", int(u), cand.shape[0], cand.tobytes())
        return self._submit("membership", key, u=int(u), candidates=cand,
                            tenant=tenant, deadline_s=deadline_s)

    def submit_triangle_count(self, *, tenant: str = "default",
                              deadline_s: Optional[float] = None) -> int:
        """Triangle-count query over the live graph (shared engine pass)."""
        return self._submit("tc", ("tc",), tenant=tenant,
                            deadline_s=deadline_s)

    def submit_clique_count(self, k: int = 4, *, tenant: str = "default",
                            deadline_s: Optional[float] = None) -> int:
        """k-clique-count query (k in {4, 5}) over the live graph.

        Both sizes fold every edge, so like ``tc`` they carry a whole-graph
        footprint: any delta invalidates a cached count. k = 5 runs through
        the engine's compiled 4-way AND set expression.
        """
        if k not in (4, 5):
            raise ValueError(f"clique count supports k in {{4, 5}}, got {k}")
        return self._submit("cliques", ("cliques", int(k)), k=int(k),
                            tenant=tenant, deadline_s=deadline_s)

    def submit_local_cluster(self, seed: int, alpha: float = 0.15,
                             eps: float = 1e-4, *, tenant: str = "default",
                             deadline_s: Optional[float] = None) -> int:
        """Seed-centric local cluster query (``localcluster(seed, α, ε)``).

        All localcluster requests sharing ``(alpha, eps)`` in one flush run
        as a single pow2-padded seed batch through the batched PPR push +
        sweep — the local-clustering analogue of the shared cardinality
        pass. Duplicate seeds in a group dedup through the canonical key
        and fan back out by request id. The answer value is a dict with
        ``members`` (int32[size] vertex ids of the best cluster),
        ``conductance``, ``size`` and ``support``.
        """
        key = ("localcluster", int(seed), float(alpha), float(eps))
        return self._submit("localcluster", key, seed=int(seed),
                            alpha=float(alpha), eps=float(eps),
                            tenant=tenant, deadline_s=deadline_s)

    def pending_count(self) -> int:
        """Number of submitted-but-unflushed requests."""
        with self._lock:
            return len(self._queue)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    def flush(self) -> Dict[int, QueryResult]:
        """Answer everything pending; return (and clear) unclaimed results.

        Results answered earlier by the admission policy (``max_batch`` /
        ``poll()`` / the async worker) and not yet drained are included.
        Synchronous in both modes: the flush body runs on the calling
        thread, serialized against the worker.
        """
        self._flush_queue()
        return self.drain()

    def poll(self) -> Dict[int, QueryResult]:
        """Apply the admission policy, then drain.

        Flushes when the queue holds ``max_batch`` requests or the oldest
        pending request has waited ``max_wait_s``; either way returns every
        answered-but-undrained result (possibly none). With ``async_flush``
        the worker applies the policy continuously, so ``poll()`` just
        drains.
        """
        if self._worker is None:
            with self._lock:
                due, _ = self._due_locked()
            if due:
                self._flush_queue()
        return self.drain()

    def drain(self) -> Dict[int, QueryResult]:
        """Return and clear every answered-but-unclaimed result."""
        with self._lock:
            out, self._results = self._results, {}
        return out

    # ------------------------------------------------------------------
    # background flush worker
    # ------------------------------------------------------------------

    def _due_locked(self) -> Tuple[bool, Optional[float]]:
        """Admission decision under ``_lock``: ``(due_now, wait_timeout)``.

        Due when the queue reached ``max_batch``, the oldest request aged
        past ``max_wait_s``, the earliest SLO deadline leaves less slack
        than one smoothed flush service time, or (async mode) the queue hit
        the ``max_backlog`` high-water mark. Otherwise returns how long the
        worker may sleep before the earliest of those can trip.
        """
        if not self._queue:
            return False, None
        if self.max_batch is not None and len(self._queue) >= self.max_batch:
            return True, None
        if self._worker is not None and len(self._queue) >= self.max_backlog:
            # a full backlog must always drain: with no max_batch /
            # max_wait_s and deadline-free submits nothing else ever comes
            # due, and the submitter blocked on the backpressure loop
            # cannot rescue itself with an explicit flush()
            return True, None
        now = time.perf_counter()
        timeouts = []
        if self.max_wait_s is not None:
            age = now - self._queue[0].t_submit
            if age >= self.max_wait_s:
                return True, None
            timeouts.append(self.max_wait_s - age)
        deadlines = [p.deadline for p in self._queue
                     if p.deadline is not None]
        if deadlines:
            slack = min(deadlines) - now - self._service_ewma
            if slack <= 0.0:
                return True, None
            timeouts.append(slack)
        return False, (min(timeouts) if timeouts else None)

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                due, timeout = self._due_locked()
                while not due and not self._closed:
                    self._cond.wait(timeout)
                    due, timeout = self._due_locked()
                if self._closed and not self._queue:
                    return            # final flush already happened below
            self._flush_queue()

    # ------------------------------------------------------------------
    # the flush itself
    # ------------------------------------------------------------------

    def _link_candidates(self, host, u: int) -> np.ndarray:
        """Distance-2 non-neighbors of ``u`` on the flush snapshot (sorted)."""
        nbrs = host.neighbors(int(u))
        cand = np.unique(np.concatenate(
            [host.neighbors(int(x)) for x in nbrs]
            or [np.zeros(0, np.int32)]))
        return cand[(cand != u) & ~np.isin(cand, nbrs)]

    def _flush_queue(self) -> None:
        """Answer every pending request: cache, coalesce, one batch per
        shape class for the misses, then fan out by request id."""
        with self._flush_lock:
            with self._lock:
                queue, self._queue = self._queue, []
                for p in queue:
                    left = self._pending_tenant.get(p.tenant, 1) - 1
                    if left > 0:
                        self._pending_tenant[p.tenant] = left
                    else:
                        self._pending_tenant.pop(p.tenant, None)
            if not queue:
                return
            queue.sort(key=_edf_key)        # earliest-deadline-first
            t0 = time.perf_counter()
            with trace.span("server.flush") as fsp:
                # read lease: pins the captured view against device-buffer
                # donation for the whole flush (a delta landing meanwhile
                # builds version N+1 without donating version N's buffers)
                snap = self.stream.acquire_serving_view()
                try:
                    self._flush_body(queue, snap, fsp)
                finally:
                    self.stream.release_serving_view(snap)
            dt = time.perf_counter() - t0
            # smoothed service-time estimate drives the worker's
            # deadline-pressure check (how early must a flush start so its
            # requests still make their SLOs); _due_locked reads it under
            # _lock, so the read-modify-write must hold it too
            with self._lock:
                self._service_ewma = (
                    dt if self._service_ewma == 0.0
                    else 0.8 * self._service_ewma + 0.2 * dt)
        with self._cond:
            self._cond.notify_all()          # wake poll()/flush() waiters

    def _flush_body(self, queue: List[_Pending], snap, fsp) -> None:
        """The traced body of :meth:`_flush_queue` (``fsp`` is its span).

        Snapshot-isolated: ``snap`` is one lease-held published ServingView
        captured by the caller, and the body reads *nothing* from the live
        session — deltas applied concurrently publish later views and
        cannot tear this flush.
        """
        self._c_flushes.inc()
        # one read of the published cache reference for the whole body: a
        # concurrent close() nulls self.cache, and re-reading it mid-flush
        # would turn that into an AttributeError between the None check and
        # the use (the alias keeps the cache alive until this flush ends)
        cache = self.cache
        sess = snap.session
        host = snap.host
        version = snap.version
        vol_now = 2.0 * host.m

        # coalesce: identical requests (same canonical key) compute once
        by_key: "collections.OrderedDict[Tuple, List[_Pending]]" = \
            collections.OrderedDict()
        for p in queue:
            by_key.setdefault(p.key, []).append(p)
        coalesced = len(queue) - len(by_key)
        self._c_coalesced.inc(coalesced)

        answers: Dict[Tuple, object] = {}
        misses: List[Tuple] = []
        with trace.span("cache.lookup", keys=len(by_key),
                        enabled=cache is not None) as csp:
            for key in by_key:
                if cache is not None:
                    hit = cache.get(
                        key, vol_now if key[0] == "localcluster" else None)
                    if hit is not None:
                        answers[key] = hit.value
                        continue
                misses.append(key)
            csp.set(hits=len(by_key) - len(misses))
        # invariant 8 provenance: every answer in this flush is attributable
        # to this span's cache/coalesce/pad accounting
        fsp.set(requests=len(queue), unique_keys=len(by_key),
                coalesced=coalesced, cache_hits=len(by_key) - len(misses),
                version=version, epoch=snap.epoch,
                tenants=len({p.tenant for p in queue}))

        # one shared cardinality pass for ALL uncached pair-scored requests;
        # link-prediction candidates materialize HERE, from the snapshot
        pair_keys: List[Tuple] = []
        pair_blocks: List[np.ndarray] = []
        lp_cand: Dict[Tuple, np.ndarray] = {}
        for key in misses:
            p0 = by_key[key][0]
            if p0.kind == "similarity":
                pair_keys.append(key)
                pair_blocks.append(p0.pairs)
            elif p0.kind == "linkpred":
                u = p0.payload["u"]
                cand = self._link_candidates(host, u)
                lp_cand[key] = cand
                pair_keys.append(key)
                pair_blocks.append(np.stack(
                    [np.full(cand.shape[0], u, np.int32),
                     cand.astype(np.int32)], axis=1))
        scores: Dict[Tuple, np.ndarray] = {
            key: np.zeros(0, np.float32) for key in pair_keys}
        total = sum(b.shape[0] for b in pair_blocks)
        if total:
            with trace.span("server.pair_batch", pairs=total) as psp:
                pairs = np.concatenate(pair_blocks, axis=0)
                padded = np.zeros((pow2_bucket(total, self.min_batch), 2),
                                  np.int32)
                padded[:total] = pairs
                self._pad_add("pairs", total, padded.shape[0])
                psp.set(padded=padded.shape[0])
                pairs_t = torch.from_numpy(padded).to(sess.graph.device)
                with trace.span("engine.pair_cards",
                                pairs=padded.shape[0]) as ksp:
                    fn = eng.pair_cardinality_fn(sess.graph, sess.sketch,
                                                 sess.plan)
                    cards_t = eng.map_edges(pairs_t, fn, sess.plan)
                    ksp.fence(cards_t)
                # degrees gathered on the device at the queried pairs only —
                # copying all of graph.deg here would move O(n) bytes per
                # flush, against the streaming path's delta-sized-transfer
                # contract
                du_t = sess.graph.deg[pairs_t[:, 0].long()].to(torch.float32)
                dv_t = sess.graph.deg[pairs_t[:, 1].long()].to(torch.float32)
                # fence the gathers on the batch span before copying to
                # host: the copy below would otherwise block inside the
                # span with the wait charged to whatever syncs first
                psp.fence(dv_t)
                cards = cards_t.cpu().numpy()
                du_all, dv_all = du_t.cpu().numpy(), dv_t.cpu().numpy()
                if sess.sketch is not None:
                    # live error-interval estimate for the answers just
                    # computed (real rows only, padding excluded)
                    accuracy.record_pair_error(
                        sess.sketch, cards[:total], du_all[:total],
                        dv_all[:total], self.metrics)
                off = 0
                for key, block in zip(pair_keys, pair_blocks):
                    k = block.shape[0]
                    scores[key] = similarity_from_cardinalities(
                        torch.from_numpy(cards[off:off + k]),
                        torch.from_numpy(du_all[off:off + k]),
                        torch.from_numpy(dv_all[off:off + k]),
                        by_key[key][0].measure).numpy()
                    off += k

        # one batched push + sweep per (alpha, eps) group of uncached seeds
        # (seeds are unique per group by construction: the key dedups them;
        # groups run in EDF order because the queue was EDF-sorted)
        lc_groups: "collections.OrderedDict[Tuple, List[Tuple]]" = \
            collections.OrderedDict()
        for key in misses:
            if key[0] == "localcluster":
                lc_groups.setdefault(key[2:], []).append(key)
        deg_host = host.deg
        for (alpha, eps), group in lc_groups.items():
            seeds = np.array([key[1] for key in group], np.int32)
            # pad with a repeat of the first seed (dropped below), to the
            # same pow2 floor as the pair path
            padded = np.full(pow2_bucket(seeds.size, self.min_batch),
                             seeds[0], np.int32)
            padded[:seeds.size] = seeds
            self._pad_add("localcluster", int(seeds.size), padded.shape[0])
            with trace.span("server.localcluster_batch",
                            seeds=int(seeds.size), padded=padded.shape[0],
                            alpha=float(alpha), eps=float(eps)) as lsp:
                res = sess.local_cluster(padded, alpha=alpha, eps=eps)
                lsp.set(sparse=res.frontier is not None,
                        spilled=bool(res.spilled))
                lsp.fence(res.best_conductance)
            sizes = res.best_size.cpu().numpy()
            phis = res.best_conductance.cpu().numpy()
            sup = res.support.cpu().numpy()
            order = res.order.cpu().numpy()
            for i, key in enumerate(group):
                value = {
                    # .copy(): a bare slice would pin the whole padded
                    # [S, n] order matrix for as long as the answer lives
                    "members": order[i, :sizes[i]].copy(),
                    "conductance": float(phis[i]),
                    "size": int(sizes[i]),
                    "support": int(sup[i]),
                }
                # frozen even with the cache off: coalesced duplicates
                # share this object across request ids
                answers[key] = _freeze(value)
                if cache is not None:
                    # conductance reads the total volume through
                    # min(vol, 2m − vol): cache only clusters provably on
                    # the small side, guarded against later volume drift
                    swept = order[i, :sup[i]]
                    swept = swept[swept < host.n]
                    max2vol = 2.0 * float(deg_host[swept].sum())
                    if cache.cacheable(max2vol, vol_now):
                        fp = Footprint.of(res.footprint(i), key[1])
                        cache.put(key, value, fp, version,
                                  max2vol=max2vol, vol_total=vol_now,
                                  epoch=snap.epoch)

        # remaining miss kinds + cache fills
        for key in misses:
            kind = key[0]
            if kind == "localcluster":
                continue                       # answered in the group pass
            p0 = by_key[key][0]
            if kind == "similarity":
                value = scores[key]
                fp = Footprint.of(p0.pairs)
            elif kind == "linkpred":
                s = scores[key]
                cand = lp_cand[key]
                top = np.argsort(-s, kind="stable")[:p0.payload["top_k"]]
                value = {"candidates": cand[top], "scores": s[top]}
                # the candidate set itself is a function of N(u)'s rows: a
                # new edge at any neighbor mints a new candidate, so the
                # footprint is {u} ∪ N(u) ∪ candidates
                u = p0.payload["u"]
                fp = Footprint.of(u, host.neighbors(u), cand)
            elif kind == "membership":
                cand = p0.payload["candidates"]
                padded = np.full(pow2_bucket(cand.shape[0], self.min_batch),
                                 host.n, np.int32)
                padded[:cand.shape[0]] = cand
                self._pad_add("membership", cand.shape[0], padded.shape[0])
                value = snap.membership(
                    p0.payload["u"], padded).cpu().numpy()[:cand.shape[0]]
                fp = Footprint.of(p0.payload["u"])
            elif kind == "tc":
                value = float(sess.triangle_count())
                fp = Footprint.whole_graph()
            elif kind == "cliques":
                if p0.payload["k"] == 5:
                    value = float(sess.five_clique_count())
                else:
                    value = float(sess.four_clique_count())
                fp = Footprint.whole_graph()
            else:  # pragma: no cover - guarded at submit time
                raise ValueError(kind)
            # frozen unconditionally: coalesced duplicates (and later cache
            # hits) all share this object — nobody gets to mutate it
            answers[key] = _freeze(value)
            if cache is not None:
                cache.put(key, value, fp, version, epoch=snap.epoch)

        # fan out: every request id gets its key's (shared) answer
        misses_deadline = 0
        with self._lock:
            for p in queue:
                t_now = time.perf_counter()
                lat = t_now - p.t_submit
                missed = p.deadline is not None and t_now > p.deadline
                misses_deadline += missed
                res = QueryResult(p.request_id, p.kind, answers[p.key],
                                  p.submitted_version, version, lat,
                                  p.tenant, missed)
                self._h_latency.observe(lat)
                self._h_staleness.observe(res.staleness)
                self._c_served.inc()
                self.metrics.counter("server_served_total", kind=p.kind).inc()
                self.metrics.counter("server_tenant_served_total",
                                     tenant=p.tenant).inc()
                self.metrics.histogram("server_tenant_latency_s",
                                       window=self._stats_window,
                                       tenant=p.tenant).observe(lat)
                if missed:
                    self.metrics.counter("server_deadline_miss_total",
                                         tenant=p.tenant).inc()
                self._results[p.request_id] = res
        fsp.set(deadline_misses=misses_deadline)

    def stats(self) -> dict:
        """Serving counters: per-kind served/pad numbers, latency
        percentiles (only once something was served), coalescing, cache
        effectiveness, and per-tenant admission accounting (served / shed /
        deadline misses / latency tail) once any tenant-labelled traffic
        exists.

        A view over :attr:`metrics` — every number below is read back from
        a registry instrument; the dict shape and values are bit-compatible
        with the pre-registry implementation (percentiles recomputed from
        the histogram's raw window with the same numpy calls).
        """
        by_kind = {dict(labels)["kind"]: inst.value
                   for labels, inst in
                   self.metrics.labelled("server_served_total").items()
                   if labels}
        with self._lock:
            pad_names = list(self._pad)
        pad = {name: (
            self.metrics.value("server_pad_rows", path=name, rows="real"),
            self.metrics.value("server_pad_rows", path=name, rows="padded"))
            for name in pad_names}
        out = {
            "served": self._c_served.value,
            "flushes": self._c_flushes.value,
            "coalesced": self._c_coalesced.value,
            "by_kind": by_kind,
            "pad_overhead": {
                name: (padded / real - 1.0 if real else 0.0)
                for name, (real, padded) in pad.items()},
        }
        if self._c_served.value:
            lat = self._h_latency.values()
            out["latency_mean_s"] = float(lat.mean())
            out["latency_p95_s"] = float(np.percentile(lat, 95))
            out["staleness_mean"] = float(np.mean(self._h_staleness.values()))
        tenants: Dict[str, dict] = {}
        for name, field in (("server_tenant_served_total", "served"),
                            ("server_shed_total", "shed"),
                            ("server_deadline_miss_total",
                             "deadline_missed")):
            for labels, inst in self.metrics.labelled(name).items():
                t = dict(labels)["tenant"]
                tenants.setdefault(t, {"served": 0, "shed": 0,
                                       "deadline_missed": 0})[field] = \
                    inst.value
        for labels, inst in \
                self.metrics.labelled("server_tenant_latency_s").items():
            vals = inst.values()
            if vals.size:
                tenants.setdefault(
                    dict(labels)["tenant"],
                    {"served": 0, "shed": 0, "deadline_missed": 0}).update(
                    latency_p50_s=float(np.percentile(vals, 50)),
                    latency_p95_s=float(np.percentile(vals, 95)),
                    latency_p99_s=float(np.percentile(vals, 99)))
        if tenants:
            out["tenants"] = tenants
            out["shed"] = sum(t["shed"] for t in tenants.values())
        cache = self.cache              # one read; close() may null it
        if cache is not None:
            out["cache"] = cache.stats()
        return out
