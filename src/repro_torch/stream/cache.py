"""Versioned serving-tier result cache with delta-precise invalidation.

Real serving traffic is heavily repeated and skewed, so the biggest win
after device-resident deltas is not recomputing answers whose inputs did
not change. ProbGraph's fixed-size sketch rows make that *precise*: every
answer carries an :class:`repro_torch.engine.Footprint` — the exact vertex
set whose adjacency/degree/sketch rows it was computed from — and
``StreamSession.apply_delta`` publishes each delta's ``touched ∪ rebuilt``
vertex set, so the cache evicts exactly the entries whose footprint
intersects the delta. Everything else is served straight from cache,
bit-identical (under the strict error-budget policy) to a recomputation on
the live graph.

Two provenance guards keep entries honest beyond the footprint:

* **whole-graph answers** (triangle counts fold every edge) are evicted on
  *any* real delta or maintenance rebuild;
* **local-cluster answers** additionally depend on the total volume
  ``2m`` through the sweep's ``min(vol, vol_total − vol)`` denominator.
  Entries record the largest swept prefix volume; a hit is served only
  while ``min`` provably resolved to the prefix volume at both cache and
  serve time (``max2vol ≤ min(vol_total_then, vol_total_now)``, with a
  small slack against float32 cumsum rounding). Oversized clusters —
  more than half the graph's volume — are simply not cached.

The cache is LRU-bounded; all counters are exposed by :meth:`stats` so
benchmarks and tests can assert that invalidation evicts only
footprint-intersecting entries.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, Optional, Set, Tuple

import numpy as np

from ..engine.api import Footprint
from ..obs import trace

# how many recent invalidations the stale-put guard remembers; a put whose
# epoch predates the oldest remembered invalidation cannot be proven fresh
# and is conservatively rejected — 256 publications of slack is far beyond
# any real flush-vs-delta race window
_INVAL_LOG_LEN = 256

# slack (in volume units = 2·edges) for the local-cluster volume guard: the
# sweep's cumsum runs in float32, so a prefix within one edge of half the
# total volume cannot be proven to resolve min(vol, rest) identically
_VOL_GUARD_SLACK = 4.0


@dataclasses.dataclass
class CacheEntry:
    """One cached answer plus the provenance that keeps it honest.

    Attributes:
      key:       the canonical ``(kind, args…)`` request key.
      value:     the answer exactly as the server would have computed it
                 (arrays are frozen read-only before insertion).
      footprint: the vertex dependency set (``Footprint.whole_graph()`` for
                 answers no delta can survive).
      version:   graph version the answer was computed at (observability
                 only — validity is maintained eagerly by eviction).
      max2vol:   local-cluster only: twice the largest swept prefix volume.
      vol_total: local-cluster only: the total volume ``2m`` at cache time.
    """

    key: Tuple
    value: object
    footprint: Footprint
    version: int
    max2vol: Optional[float] = None
    vol_total: Optional[float] = None

    def vol_safe(self, vol_total_now: Optional[float]) -> bool:
        """Is the entry's volume guard satisfied at serve time?"""
        if self.max2vol is None:
            return True
        if vol_total_now is None or self.vol_total is None:
            return False
        return (self.max2vol + _VOL_GUARD_SLACK
                <= min(self.vol_total, vol_total_now))


class ResultCache:
    """LRU result cache keyed by canonical request, evicted by footprint.

    ``get``/``put`` are the serving hot path; ``invalidate`` is the delta
    listener fed by ``StreamSession`` with each delta's ``touched ∪
    rebuilt`` vertex set. An inverted vertex → keys index makes
    invalidation cost proportional to the delta and the entries it actually
    kills, never to the cache size.

    With async serving, flushes and the delta thread hit the cache
    concurrently, so every operation holds one re-entrant lock, and
    ``put`` carries a **stale-put guard**: a flush snapshot-isolated at
    epoch E may finish computing *after* a later delta already invalidated
    the vertices its answer depends on — inserting then would resurrect a
    dead entry. ``invalidate`` logs ``(epoch, vertices)`` for the last
    :data:`_INVAL_LOG_LEN` publications; ``put(..., epoch=E)`` is rejected
    (counted in ``rejected_stale``) when any logged invalidation newer than
    E intersects the entry's footprint, when the entry is whole-graph with
    any newer invalidation at all, or when E predates the log. *Hits* need
    no such guard: an entry that survived every invalidation up to the
    reader's snapshot epoch was, by the eviction invariant, valid at that
    epoch.
    """

    # machine-checked lock discipline (tools/pgcheck PG001): every piece of
    # cache state — entry map, inverted index, whole-graph set, stale-put
    # log — moves only under the one re-entrant lock. Internals that rely
    # on the caller's lock carry the `_locked` suffix instead.
    _GUARDED_BY = {
        "_entries": "_lock",
        "_by_vertex": "_lock",
        "_whole": "_lock",
        "_inval_log": "_lock",
        "_inval_floor": "_lock",
    }

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._lock = threading.RLock()
        self._entries: "collections.OrderedDict[Tuple, CacheEntry]" = \
            collections.OrderedDict()
        self._by_vertex: Dict[int, Set[Tuple]] = {}
        self._whole: Set[Tuple] = set()
        # stale-put guard state: recent (epoch, vertex-set) invalidations
        # plus the epoch floor below which the log no longer proves anything
        self._inval_log: "collections.deque[Tuple[int, Set[int]]]" = \
            collections.deque()
        self._inval_floor: Optional[int] = None
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evicted_footprint = 0      # precise: footprint ∩ delta ≠ ∅
        self.evicted_whole = 0          # whole-graph entries, any real delta
        self.evicted_capacity = 0       # LRU pressure
        self.evicted_guard = 0          # local-cluster volume guard failed
        self.rejected_stale = 0         # put raced a newer invalidation

    def __len__(self) -> int:
        """Number of live entries."""
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Tuple) -> bool:
        """Is ``key`` currently cached? (No hit/miss accounting.)"""
        with self._lock:
            return key in self._entries

    # ------------------------------------------------------------------
    # hot path
    # ------------------------------------------------------------------

    def get(self, key: Tuple, vol_total_now: Optional[float] = None
            ) -> Optional[CacheEntry]:
        """Look up ``key``; returns the entry on a provable hit, else None.

        ``vol_total_now`` (the live graph's ``2m``) must be passed for
        local-cluster keys so the volume guard can be checked; a guard
        failure drops the entry (it cannot be proven fresh).
        """
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and not entry.vol_safe(vol_total_now):
                self._remove_locked(key)
                self.evicted_guard += 1
                entry = None
            if entry is None:
                self.misses += 1
                return None
            self.hits += 1
            self._entries.move_to_end(key)
            return entry

    @staticmethod
    def cacheable(max2vol: float, vol_total: float) -> bool:
        """Can a local-cluster answer with this swept volume be cached at
        all? The admission twin of :meth:`CacheEntry.vol_safe` — both sides
        of the volume guard live here so they cannot drift apart."""
        return max2vol + _VOL_GUARD_SLACK <= vol_total

    def _put_is_stale_locked(self, footprint: Footprint,
                      epoch: Optional[int]) -> bool:
        """Did any invalidation newer than the put's epoch kill this entry
        before it could be inserted? (Caller holds the lock.)"""
        if epoch is None or not self._inval_log:
            return False                 # no provenance / nothing newer
        if self._inval_floor is not None and epoch < self._inval_floor:
            return True                  # predates the log: unprovable
        for ep, verts in self._inval_log:
            if ep <= epoch:
                continue
            if footprint.is_whole_graph:
                return True              # any real change kills whole-graph
            if footprint.intersects(np.fromiter(verts, np.int64,
                                                count=len(verts))):
                return True
        return False

    def put(self, key: Tuple, value: object, footprint: Footprint,
            version: int, max2vol: Optional[float] = None,
            vol_total: Optional[float] = None,
            epoch: Optional[int] = None) -> None:
        """Insert (or replace) an entry and index its footprint.

        ``epoch`` is the publication epoch of the serving view the answer
        was computed from; the stale-put guard drops the insert when a
        newer logged invalidation already covered it (see the class
        docstring). ``epoch=None`` skips the guard (single-threaded
        callers).
        """
        with self._lock:
            if self._put_is_stale_locked(footprint, epoch):
                self.rejected_stale += 1
                return
            if key in self._entries:
                self._remove_locked(key)
            while len(self._entries) >= self.capacity:
                # unindex BEFORE dropping the entry: _unindex_locked reads
                # entry's footprint, so popitem-first would leak the dead
                # key in every _by_vertex bucket (over-eviction + inflated
                # counters)
                self._remove_locked(next(iter(self._entries)))
                self.evicted_capacity += 1
            entry = CacheEntry(key, value, footprint, version,
                               max2vol=max2vol, vol_total=vol_total)
            self._entries[key] = entry
            if footprint.is_whole_graph:
                self._whole.add(key)
            else:
                for v in footprint.vertices:
                    self._by_vertex.setdefault(int(v), set()).add(key)
            self.inserts += 1

    # ------------------------------------------------------------------
    # invalidation feed
    # ------------------------------------------------------------------

    def invalidate(self, vertices, epoch: Optional[int] = None) -> int:
        """Evict exactly the entries invalidated by a delta/rebuild.

        ``vertices`` is the delta's ``touched ∪ rebuilt`` vertex set; every
        entry whose footprint intersects it is evicted, plus every
        whole-graph entry. ``epoch`` (the change's publication epoch) feeds
        the stale-put guard log. Returns the number of evictions.
        """
        vertices = np.asarray(vertices).reshape(-1)
        if vertices.size == 0:
            return 0
        with trace.span("cache.invalidate",
                        vertices=int(vertices.size)) as sp, self._lock:
            if epoch is not None:
                self._inval_log.append(
                    (int(epoch), set(int(v) for v in vertices)))
                while len(self._inval_log) > _INVAL_LOG_LEN:
                    self._inval_floor = self._inval_log.popleft()[0]
            doomed: Set[Tuple] = set()
            for v in vertices:
                doomed |= self._by_vertex.get(int(v), set())
            n_fp = len(doomed)
            whole = set(self._whole)
            for key in doomed:
                self._remove_locked(key)
            for key in whole:
                self._remove_locked(key)
            self.evicted_footprint += n_fp
            self.evicted_whole += len(whole)
            sp.set(evicted_footprint=n_fp, evicted_whole=len(whole))
        return n_fp + len(whole)

    def clear(self) -> None:
        """Drop every entry (counters are kept)."""
        with self._lock:
            self._entries.clear()
            self._by_vertex.clear()
            self._whole.clear()

    # ------------------------------------------------------------------
    # internals / stats
    # ------------------------------------------------------------------

    def _unindex_locked(self, key: Tuple) -> None:
        entry = self._entries.get(key)
        self._whole.discard(key)
        if entry is None or entry.footprint.vertices is None:
            return
        for v in entry.footprint.vertices:
            bucket = self._by_vertex.get(int(v))
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    del self._by_vertex[int(v)]

    def _remove_locked(self, key: Tuple) -> None:
        self._unindex_locked(key)
        self._entries.pop(key, None)

    def stats(self) -> dict:
        """Counters: hit rate, entries, and the eviction breakdown."""
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / lookups if lookups else 0.0,
                "inserts": self.inserts,
                "evicted_footprint": self.evicted_footprint,
                "evicted_whole": self.evicted_whole,
                "evicted_capacity": self.evicted_capacity,
                "evicted_guard": self.evicted_guard,
                "rejected_stale": self.rejected_stale,
            }
