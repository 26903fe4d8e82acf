"""Incremental sketch maintenance for streaming graphs.

ProbGraph's representations are cheap to *maintain*, not just to intersect:

  * Bloom inserts are monotone — OR only the new elements' bit positions
    into the touched rows.
  * k-Hash inserts are lexicographic (hash, element) min-merges per hash fn.
  * 1-Hash inserts are sorted merges of (hash, element) pairs, keep-k.
  * KMV inserts are sorted merges of unit-interval hash values, keep-k.

All four incremental updates are **bit-identical** to a from-scratch rebuild
on the post-insert graph: the builders break hash ties by element id, which
is the (hash, element) lexicographic order used here.

The inserts arrive as a CSR of the delta (:meth:`DeltaResult.insert_rows`),
one entry per (vertex, new neighbor) pair: no padded ``[T, L]`` table, so
a hub that gains hundreds of neighbors costs its own entries only. Hashes
are uint32 values held in int64, so every comparison is unsigned.

Deletions are not monotone: a deleted element may be the very minimum a row
stores. Deletion therefore marks rows *dirty* and defers work: each dirty
row tracks how many deleted-but-still-sketched (phantom) elements it holds,
and an :class:`ErrorBudgetPolicy` — driven by the paper's own accuracy
bounds in ``core.bounds`` — decides when the accumulated staleness exceeds
the sketch's intrinsic error scale and the row must be rebuilt. Builds and
rebuilds run the CSR row builders of ``core.sketches`` over the device
CSR (a rebuild over a CSR gathered from the rows being rebuilt), in
bounded chunks.

Every update builds a new sketch tensor; the published one is never
written, so a flush that still reads it is not torn.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import bounds
from ..core.hashing import _GOLDEN, _MASK, _mul32, hash_u32, \
    hash_unit_interval
from ..core.sketches import (_CHUNK_BITS, _CHUNK_CANDIDATES, _ELEM_SPAN,
                             _NO_KEY, _row_chunks, _u32_to_i32, KMV_PAD,
                             PAD_HASH, SketchSet, bloom_positions, bloom_rows,
                             bloom_words_for_budget, khash_rows, kmv_rows,
                             minhash_k_for_budget, onehash_rows)
from ..obs import trace
from .dynamic_graph import DeltaResult, DynamicGraph


# ----------------------------------------------------------------------------
# error-budget policy (core.bounds-driven deferral of deletion rebuilds)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ErrorBudgetPolicy:
    """When must a dirty (deletion-pending) sketch row be rebuilt?

    Every phantom element (deleted from the graph, still in the sketch)
    perturbs any |N_u ∩ N_v| estimate through that row by at most 1, so a
    row's stale count is an additive error bound on its answers. The policy
    tolerates staleness up to ``rel_tolerance`` × the sketch's own
    statistical error scale at the row's degree (Prop IV.1 RMSE for Bloom,
    inverted Prop IV.2 for MinHash/KMV): deferred deletions hide below the
    estimator's intrinsic noise floor.

    ``rel_tolerance=0`` (the default) rebuilds every dirty row immediately —
    strict mode, streaming answers stay bit-identical to a from-scratch
    build. ``max_stale`` is an absolute cap independent of degree.
    """

    rel_tolerance: float = 0.0
    confidence: float = 0.05
    max_stale: int = 1 << 30

    def allowed_stale(self, sketch: SketchSet, degrees: np.ndarray) -> np.ndarray:
        """Per-row stale-count budget at the given degrees (0 = strict)."""
        if self.rel_tolerance <= 0.0:
            return np.zeros(np.shape(degrees), dtype=np.float64)
        if sketch.kind == "bf":
            scale = bounds.bf_and_rmse(degrees, sketch.total_bits,
                                       sketch.num_hashes)
        else:
            scale = bounds.minhash_error_scale(degrees, sketch.k,
                                               self.confidence)
        return np.minimum(self.rel_tolerance * scale, float(self.max_stale))


#: rebuild-immediately policy: streaming ≡ from-scratch, bit for bit
STRICT_POLICY = ErrorBudgetPolicy(rel_tolerance=0.0)


# ----------------------------------------------------------------------------
# per-kind inserts over a CSR of the delta
# ----------------------------------------------------------------------------

def _bloom_insert(data: torch.Tensor, verts: torch.Tensor, row: torch.Tensor,
                  nbrs: torch.Tensor, num_hashes: int, seed: int
                  ) -> torch.Tensor:
    """OR each new (row, element) pair's bit positions into its row.

    Distinct set bits of one word sum to their OR, so the bits are made
    unique and added per word; the result is a new tensor."""
    t, words = verts.shape[0], data.shape[1]
    total_bits = words * 32
    pos = bloom_positions(nbrs, num_hashes, total_bits, seed)   # [E, b]
    bit = torch.unique((row[:, None] * total_bits + pos).reshape(-1))
    acc = torch.zeros(t * words, dtype=torch.int64, device=data.device)
    acc.index_add_(0, bit >> 5, torch.ones_like(bit) << (bit & 31))
    out = data.clone()
    out[verts] = data[verts] | _u32_to_i32(acc).reshape(t, words)
    return out


def _khash_seeds(k: int, seed: int, device) -> torch.Tensor:
    """The k hash-function seeds of ``hash_family(x, k, seed)``."""
    return (torch.arange(k, dtype=torch.int64, device=device)
            + _mul32(torch.tensor(seed & _MASK, dtype=torch.int64,
                                  device=device), _GOLDEN)) & _MASK


def _khash_insert(data: torch.Tensor, verts: torch.Tensor, row: torch.Tensor,
                  nbrs: torch.Tensor, n: int, seed: int) -> torch.Tensor:
    """Per-hash-fn minimum of the key ``hash·2³¹ + element`` over each row's
    current element and its new ones: the lexicographic (hash, element)
    minimum of the reference's argmin merge (pad slots, ``>= n``, hold no
    element)."""
    k = data.shape[1]
    seeds = _khash_seeds(k, seed, data.device)
    cur = data[verts]                                              # [T, k]
    valid = cur < n
    cur_key = torch.where(
        valid, hash_u32(torch.where(valid, cur, 0), seeds[None, :])
        * _ELEM_SPAN + cur.to(torch.int64), _NO_KEY)
    new_key = (hash_u32(nbrs[:, None], seeds[None, :]) * _ELEM_SPAN
               + nbrs.to(torch.int64)[:, None])                    # [E, k]
    cur_key.scatter_reduce_(0, row[:, None].expand(-1, k), new_key, "amin")
    elems = torch.where(cur_key == _NO_KEY, n,
                        torch.remainder(cur_key, _ELEM_SPAN))
    out = data.clone()
    out[verts] = elems.to(torch.int32)
    return out


def _keep_k(row: torch.Tensor, key: torch.Tensor, t: int, k: int):
    """The k entries of smallest ``key`` in each of ``t`` rows, ties in
    input order: ``(row, rank, index)`` of the kept entries (``key`` int64
    in [0, 2³²))."""
    order = torch.sort(row * (1 << 32) + key, stable=True).indices
    r = row[order]
    counts = torch.zeros(t, dtype=torch.int64, device=row.device)
    counts.index_add_(0, row, torch.ones_like(row))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(order.numel(), device=row.device) - starts[r]
    keep = rank < k
    return r[keep], rank[keep], order[keep]


def _onehash_insert(data: torch.Tensor, verts: torch.Tensor, row: torch.Tensor,
                    nbrs: torch.Tensor, n: int, seed: int) -> torch.Tensor:
    """Merge each row's current elements with its new ones by (hash,
    element), keep k; a slot left empty or holding a ``PAD_HASH`` element
    becomes ``n``, as in the reference's merge."""
    t, k = verts.shape[0], data.shape[1]
    cur = data[verts]
    valid = (cur < n).reshape(-1)
    cur_row = torch.arange(t, device=data.device).repeat_interleave(k)
    rows = torch.cat([cur_row[valid], row])
    elems = torch.cat([cur.reshape(-1)[valid], nbrs]).to(torch.int64)
    by_elem = torch.sort(elems, stable=True).indices   # ties by element id
    rows, elems = rows[by_elem], elems[by_elem]
    h = hash_u32(elems, seed)
    r, rank, idx = _keep_k(rows, h, t, k)
    merged = torch.full((t, k), n, dtype=torch.int64, device=data.device)
    merged[r, rank] = torch.where(h[idx] == PAD_HASH, n, elems[idx])
    out = data.clone()
    out[verts] = merged.to(torch.int32)
    return out


def _kmv_insert(data: torch.Tensor, verts: torch.Tensor, row: torch.Tensor,
                nbrs: torch.Tensor, seed: int) -> torch.Tensor:
    """Merge each row's k current values with its new ones, keep the k
    smallest (positive float32 values order as their bit patterns)."""
    t, k = verts.shape[0], data.shape[1]
    vals = torch.cat([data[verts].reshape(-1),
                      hash_unit_interval(nbrs, seed)])
    rows = torch.cat([torch.arange(t, device=data.device).repeat_interleave(k),
                      row])
    r, rank, idx = _keep_k(rows, vals.view(torch.int32).to(torch.int64), t, k)
    merged = torch.full((t, k), KMV_PAD, dtype=torch.float32,
                        device=data.device)
    merged[r, rank] = vals[idx]
    out = data.clone()
    out[verts] = merged
    return out


# ----------------------------------------------------------------------------
# maintainer
# ----------------------------------------------------------------------------

class SketchMaintainer:
    """Owns one sketch of a :class:`DynamicGraph` and keeps it current.

    Inserts are absorbed incrementally (per-kind merges above); deletions
    mark rows dirty and are repaired by selective rebuild of only the dirty
    rows through the CSR row builders, when the :class:`ErrorBudgetPolicy`
    says their staleness is no longer affordable. The sketch lives on the
    graph's device, next to its device mirror.
    """

    def __init__(self, dyn: DynamicGraph, kind: str = "bf",
                 storage_budget: float = 0.25, num_hashes: int = 2,
                 seed: int = 0, words: Optional[int] = None,
                 k: Optional[int] = None,
                 policy: Optional[ErrorBudgetPolicy] = None,
                 data: Optional[torch.Tensor] = None):
        if kind not in ("bf", "kh", "1h", "kmv"):
            raise ValueError(f"unknown sketch kind: {kind}")
        self.dyn = dyn
        self.kind = kind
        self.num_hashes = int(num_hashes)
        self.seed = int(seed)
        self.policy = policy if policy is not None else STRICT_POLICY
        n, m = dyn.n, dyn.m
        if kind == "bf":
            self.words = int(words) if words is not None else \
                bloom_words_for_budget(n, m, storage_budget)
            self.k = 0
        else:
            self.words = 0
            self.k = int(k) if k is not None else \
                minhash_k_for_budget(n, m, storage_budget)
        self.dirty = np.zeros(n, dtype=bool)
        self.stale = np.zeros(n, dtype=np.int64)
        self.rows_rebuilt = 0
        self.rows_incremental = 0
        self.deltas_applied = 0
        if data is None:
            # the whole sketch from the device mirror's CSR (created here
            # if the graph has none yet: its one metered init upload)
            dev = dyn.device
            indptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(dyn.deg, out=indptr[1:])
            data = self._rows_from_csr(indptr, dev.indptr, dev.indices)
        self.sketch = SketchSet(
            data=data, kind=kind,
            num_hashes=self.num_hashes if kind == "bf" else 0,
            k=self.k, seed=self.seed, n=n)

    # -- full/selective construction through the CSR row builders ----------

    def _rows_from_csr(self, indptr: np.ndarray, indptr_dev: torch.Tensor,
                       indices: torch.Tensor) -> torch.Tensor:
        """Sketch rows of the CSR ``(indptr, indices)`` in bounded chunks:
        ``indptr`` is its host copy (int64, from 0), ``indptr_dev`` the same
        on the device."""
        n, rows = self.dyn.n, indptr.shape[0] - 1
        if self.kind == "bf":
            dtype, row_cap = torch.int32, _CHUNK_BITS // (self.words * 32)
            entry_cap = _CHUNK_BITS // (4 * max(self.num_hashes, 1))

            def fn(ptr, idx):
                return bloom_rows(ptr, idx, self.words, self.num_hashes,
                                  self.seed)
        else:
            k = self.k
            dtype = torch.float32 if self.kind == "kmv" else torch.int32
            row_cap = _CHUNK_CANDIDATES // k
            entry_cap = _CHUNK_CANDIDATES // (k if self.kind == "kh" else 1)
            fn = {"kh": lambda ptr, idx: khash_rows(ptr, idx, n, k,
                                                    self.seed),
                  "1h": lambda ptr, idx: onehash_rows(ptr, idx, n, k,
                                                      self.seed),
                  "kmv": lambda ptr, idx: kmv_rows(ptr, idx, k,
                                                   self.seed)}[self.kind]
        out = torch.empty((rows, self.words or self.k), dtype=dtype,
                          device=indices.device)
        for start, stop in _row_chunks(indptr, max(row_cap, 1),
                                       max(entry_cap, 1)):
            out[start:stop] = fn(indptr_dev[start:stop + 1],
                                 indices[int(indptr[start]):
                                         int(indptr[stop])])
        return out

    # -- delta application -------------------------------------------------

    def apply(self, delta: DeltaResult) -> np.ndarray:
        """Absorb one delta; returns the vertex ids rebuilt *now* (per the
        error-budget policy — empty when all deletions stayed affordable)."""
        self.deltas_applied += 1
        verts, indptr, nbrs = delta.insert_rows(self.dyn.n)
        if verts.size:
            with trace.span("sketch.insert", kind=self.kind,
                            rows=int(verts.size),
                            entries=int(nbrs.size)) as sp:
                self._insert(verts, indptr, nbrs)
                sp.fence(self.sketch.data)
            self.rows_incremental += int(verts.size)
        if delta.deleted.size:
            ends = delta.deleted.ravel()
            self.dirty[delta.dirty] = True
            self.stale += np.bincount(ends, minlength=self.dyn.n)
        dirty_ids = np.nonzero(self.dirty)[0]
        if dirty_ids.size == 0:
            return dirty_ids
        allowed = self.policy.allowed_stale(self.sketch,
                                            self.dyn.deg[dirty_ids])
        rebuild = dirty_ids[self.stale[dirty_ids] > allowed]
        self.rebuild_rows(rebuild)
        return rebuild

    def _insert(self, verts: np.ndarray, indptr: np.ndarray,
                nbrs: np.ndarray):
        put = self.dyn.traffic.put
        verts_t = put(verts).to(torch.int64)
        counts = put(np.diff(indptr).astype(np.int32)).to(torch.int64)
        nbrs_t = put(nbrs)
        # the row of each (vertex, new neighbor) entry; output_size spares
        # the device a sync
        row = torch.repeat_interleave(
            torch.arange(verts.size, device=verts_t.device), counts,
            output_size=int(nbrs.size))
        data, n = self.sketch.data, self.dyn.n
        if self.kind == "bf":
            data = _bloom_insert(data, verts_t, row, nbrs_t,
                                 self.num_hashes, self.seed)
        elif self.kind == "kh":
            data = _khash_insert(data, verts_t, row, nbrs_t, n, self.seed)
        elif self.kind == "1h":
            data = _onehash_insert(data, verts_t, row, nbrs_t, n, self.seed)
        else:
            data = _kmv_insert(data, verts_t, row, nbrs_t, self.seed)
        self.sketch = dataclasses.replace(self.sketch, data=data)

    def rebuild_rows(self, verts: np.ndarray):
        """Selectively rebuild the given rows from the current graph through
        the CSR row builders (never the full pass)."""
        verts = np.asarray(verts, dtype=np.int64)
        if verts.size == 0:
            return
        with trace.span("sketch.rebuild", kind=self.kind,
                        rows=int(verts.size)) as sp:
            self._rebuild_rows(verts)
            sp.fence(self.sketch.data)

    def _rebuild_rows(self, verts: np.ndarray):
        # gather the rows' CSR from the device mirror: only the row ids
        # cross the bus; the host degrees give the chunk boundaries
        dev = self.dyn.device
        counts = self.dyn.deg[verts].astype(np.int64)
        indptr = np.zeros(verts.size + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        verts_t = self.dyn.traffic.put(verts.astype(np.int32)).to(torch.int64)
        counts_t = dev.deg[verts_t].to(torch.int64)
        indptr_t = torch.zeros(verts.size + 1, dtype=torch.int64,
                               device=verts_t.device)
        indptr_t[1:] = torch.cumsum(counts_t, 0)
        total = int(indptr[-1])
        row = torch.repeat_interleave(
            torch.arange(verts.size, device=verts_t.device), counts_t,
            output_size=total)
        starts = dev.indptr[verts_t].to(torch.int64)
        at = (starts[row] + torch.arange(total, device=verts_t.device)
              - indptr_t[:-1][row])
        rows = self._rows_from_csr(indptr, indptr_t, dev.indices[at])
        data = self.sketch.data.clone()
        data[verts_t] = rows
        self.sketch = dataclasses.replace(self.sketch, data=data)
        self.dirty[verts] = False
        self.stale[verts] = 0
        self.rows_rebuilt += int(verts.size)

    def flush(self) -> np.ndarray:
        """Force-rebuild every dirty row (e.g. before a checkpoint); returns
        the rebuilt vertex ids."""
        dirty_ids = np.nonzero(self.dirty)[0]
        self.rebuild_rows(dirty_ids)
        return dirty_ids

    def stats(self) -> dict:
        """Maintenance counters: incremental rows, rebuilds, staleness."""
        return {
            "kind": self.kind,
            "rows_incremental": self.rows_incremental,
            "rows_rebuilt": self.rows_rebuilt,
            "rows_dirty": int(self.dirty.sum()),
            "stale_total": int(self.stale.sum()),
            "deltas_applied": self.deltas_applied,
        }
