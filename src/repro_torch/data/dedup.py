"""MinHash near-duplicate dedup: the ProbGraph k-Hash applied to a corpus.

Documents -> w-gram shingles -> k-Hash MinHash sketches (the murmur3
finalizer of ``core.hashing``) -> LSH banding for candidate pairs ->
Jaccard estimate Ĵ_kH = matches/k -> drop docs with Ĵ ≥ threshold. The
integers are the reference's: sketches, keep mask and every stats field.

The paper's Prop IV.2 bound makes k quantitative:
P(|Ĵ−J| ≥ t) ≤ 2·exp(−2kt²), so ``k_for(j_gap, delta)`` returns the sketch
size guaranteeing false-match probability ≤ delta at a Jaccard margin j_gap.

Device design. The docs' tokens go to the device once, as one flat tensor
with doc offsets; the shingles are hashed there (uint32 wraparound kept in
int64), then the k seeds in chunks of about ``_CHUNK`` int64 elements, each
doc's minimum taken by a segment min. Banding groups rows by their exact
band contents (``unique`` over the band words, never a hash of them, which
could merge two bands and change ``checked_pairs``), and the buckets are
visited in the reference's dict order: by (first member, band). Every
candidate pair's match count is taken on the device in one batch; the
reference's sequential keep pass then runs on the host over that list.
Spans ``dedup.sketches``, ``dedup.banding`` and ``dedup.keep`` time the
three steps.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, DeviceLike, resolve_device
from ..core.hashing import _mul32, hash_u32, np_hash_u32
from ..obs import trace

_GOLDEN = 0x9E3779B9
_MASK = 0xFFFFFFFF
#: int64 elements one hashing chunk holds, about (1 GiB)
_CHUNK = 1 << 27


def k_for(j_gap: float, delta: float) -> int:
    """Smallest k with P(|Ĵ−J| ≥ j_gap) ≤ delta (Hoeffding/Prop IV.2 on Ĵ)."""
    return int(np.ceil(np.log(2.0 / delta) / (2.0 * j_gap ** 2)))


def _shingles(tokens: np.ndarray, w: int) -> np.ndarray:
    """Rolling w-gram hashes of a token array (uint32), on the host."""
    tokens = np.asarray(tokens, dtype=np.uint32)
    if len(tokens) < w:
        return np_hash_u32(tokens, 7)
    h = np.zeros(len(tokens) - w + 1, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for i in range(w):
            h = (h * np.uint32(1000003)) ^ np_hash_u32(tokens[i:i + len(h)],
                                                        7 + i)
    return h


def _device_shingles(docs: Sequence[np.ndarray], w: int, dev
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every doc's shingles (int64 holding uint32) and their doc ids, as
    :func:`_shingles` gives them per doc: a doc shorter than ``w`` hashes
    its tokens, an empty one has none."""
    lens = np.fromiter((len(d) for d in docs), dtype=np.int64,
                       count=len(docs))
    flat = (np.concatenate([np.asarray(d).astype(np.int64).ravel()
                            for d in docs]) & _MASK
            if lens.sum() else np.zeros(0, np.int64))
    tok = torch.from_numpy(flat).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    starts = torch.cumsum(lens_t, 0) - lens_t
    long = lens_t >= w
    count = torch.where(long, lens_t - w + 1, lens_t)
    doc = torch.repeat_interleave(torch.arange(len(docs), device=dev), count)
    first = torch.cumsum(count, 0) - count
    p = starts[doc] + torch.arange(doc.numel(), device=dev) - first[doc]
    if tok.numel() == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev), doc
    last = tok.numel() - 1
    h = torch.zeros_like(p)
    for i in range(w):
        h = _mul32(h, 1000003) ^ hash_u32(tok[torch.clamp(p + i, max=last)],
                                          7 + i)
    return torch.where(long[doc], h, hash_u32(tok[p], 7)), doc


def _sketch_tensor(docs: Sequence[np.ndarray], k: int, w: int, seed: int,
                   dev) -> torch.Tensor:
    """k-Hash sketches int64[N, k] (uint32 values) on ``dev``."""
    sh, doc = _device_shingles(docs, w, dev)
    out = torch.full((len(docs), k), _MASK, dtype=torch.int64, device=dev)
    seeds = (torch.arange(k, dtype=torch.int64, device=dev)
             + (seed * _GOLDEN)) & _MASK
    kc = max(1, min(k, _CHUNK // max(sh.numel(), 1)))
    sc = max(1, _CHUNK // kc)
    for k0 in range(0, k, kc):
        k1 = min(k, k0 + kc)
        block = out[:, k0:k1]
        for s0 in range(0, sh.numel(), sc):
            s1 = min(sh.numel(), s0 + sc)
            hv = hash_u32(sh[s0:s1, None], seeds[None, k0:k1])
            block.scatter_reduce_(0, doc[s0:s1, None].expand(-1, k1 - k0),
                                  hv, "amin")
    return out


def document_sketches(docs: Sequence[np.ndarray], k: int, w: int = 5,
                      seed: int = 0,
                      device: DeviceLike = DEFAULT_DEVICE) -> np.ndarray:
    """k-Hash MinHash sketches over shingles: uint32[N, k] (min hash
    values; ``0xFFFFFFFF`` throughout for a doc with no shingle), computed
    on ``device``."""
    dev = resolve_device(device)
    return _sketch_tensor(docs, k, w, seed, dev).cpu().numpy().astype(
        np.uint32)


def jaccard_estimate(sk_a: np.ndarray, sk_b: np.ndarray) -> float:
    """Ĵ_kH = aligned matches / k (paper Eq. 5 numerator)."""
    return float(np.mean(sk_a == sk_b))


def _candidates(sketches: torch.Tensor, bands: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(anchor, other) doc ids of every candidate pair, in the reference's
    visiting order: buckets of equal (band, band contents) with two or
    more members, by (first member, band), each anchor its bucket's first
    member and the others ascending."""
    n, k = sketches.shape
    dev = sketches.device
    rpb = max(1, k // bands)
    width = bands * rpb
    # band b reads columns [b·rpb, (b+1)·rpb) as the reference slices them;
    # columns past k (more bands than columns) read as empty for every doc
    padded = torch.full((n, width), -1, dtype=torch.int64, device=dev)
    padded[:, :min(width, k)] = sketches[:, :min(width, k)]
    band_id = torch.arange(bands, device=dev).repeat(n)
    rows = torch.cat([band_id[:, None], padded.reshape(n * bands, rpb)], 1)
    _, group, counts = torch.unique(rows, dim=0, return_inverse=True,
                                    return_counts=True)
    row_id = torch.arange(n * bands, device=dev)       # di · bands + b
    multi = counts[group] >= 2
    row_id, group = row_id[multi], group[multi]
    first = torch.full((counts.numel(),), n * bands, dtype=torch.int64,
                       device=dev).scatter_reduce_(0, group, row_id, "amin")
    order = torch.sort(first[group] * (n * bands) + row_id).indices
    row_id, anchor = row_id[order], first[group][order]
    other = row_id != anchor
    return anchor[other] // bands, row_id[other] // bands


def minhash_dedup(docs: Sequence[np.ndarray], threshold: float = 0.8,
                  k: int = 64, w: int = 5, bands: int = 0, seed: int = 0,
                  device: DeviceLike = DEFAULT_DEVICE
                  ) -> Tuple[np.ndarray, Dict]:
    """Returns (keep mask bool[N], stats). Keeps the first doc of each
    near-duplicate group (banded-LSH candidates, Ĵ_kH confirmation)."""
    dev = resolve_device(device)
    n = len(docs)
    if bands <= 0:
        bands = max(8, k // 4)   # 4 rows/band: P(candidate) ≈ 1 at J ≥ 0.7
    with trace.span("dedup.sketches", docs=n, k=k) as sp:
        sketches = _sketch_tensor(docs, k, w, seed, dev)
        sp.fence(sketches)
    with trace.span("dedup.banding", bands=bands) as sp:
        anchor, other = _candidates(sketches, bands)
        matches = torch.zeros(anchor.numel(), dtype=torch.int64, device=dev)
        step = max(1, _CHUNK // max(k, 1))
        for s in range(0, anchor.numel(), step):
            a, o = anchor[s:s + step], other[s:s + step]
            matches[s:s + step] = (sketches[a] == sketches[o]).sum(1)
        pairs = torch.stack([anchor, other, matches], 1).cpu().tolist()
        sp.set(candidates=len(pairs))
    with trace.span("dedup.keep", candidates=len(pairs)):
        keep = np.ones(n, dtype=bool)
        checked = 0
        dropped_pairs = []
        for a, o, mt in pairs:
            if not keep[o] or not keep[a]:
                continue
            checked += 1
            j = mt / k                     # np.mean of the k matches
            if j >= threshold:
                keep[o] = False
                dropped_pairs.append((a, o, j))
    stats = {"checked_pairs": checked, "dropped": int((~keep).sum()),
             "dropped_pairs": dropped_pairs[:32], "k": k, "bands": bands}
    return keep, stats
