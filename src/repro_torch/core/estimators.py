"""ProbGraph estimators of |X|, |X∩Y| and Jaccard (paper §IV, §IX, App. E/G).

Batched functions over rows of sketch matrices: ``[..., words]`` int32 bit
patterns of uint32 Bloom words, ``[..., k]`` int32 MinHash rows, ``[..., k]``
float32 KMV rows. torch has no popcount, so :func:`_popcount_words` is a
SWAR popcount done in int64 on the uint32 value, which keeps every shift
logical and every product in range. The MinHash match counts come from
:mod:`repro_torch.kernels.ops`, which launches the CUDA kernels for CUDA
tensors (``use_kernel=None``) or runs their plain versions.

Notation maps to the paper: B = total bits, b = #hash functions,
ones = B_{X∩Y,1}, k = sketch size.
"""
from __future__ import annotations

from typing import Optional

import torch

from .sketches import KMV_PAD, PAD_HASH

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F


def popcount32(w: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 words (as uint32): int64, same shape."""
    x = w.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return (x + (x >> 8) + (x >> 16) + (x >> 24)) & 0x3F


def _popcount_words(w: torch.Tensor) -> torch.Tensor:
    """Popcount summed over the last (word) axis: int32[...]."""
    return popcount32(w).sum(dim=-1).to(torch.int32)


def bf_size_swamidass(row: torch.Tensor, num_hashes: int) -> torch.Tensor:
    """|X|_S (Eq. 1), with the divergence fix of App. C-3 (ones==B -> ones-1)."""
    total_bits = row.shape[-1] * 32
    ones = _popcount_words(row).to(torch.float32)
    ones = torch.clamp(ones, max=total_bits - 1)
    return -(total_bits / num_hashes) * torch.log1p(-ones / total_bits)


def bf_intersection_and(row_x: torch.Tensor, row_y: torch.Tensor,
                        num_hashes: int) -> torch.Tensor:
    """|X∩Y|_AND (Eq. 2): Swamidass estimator on Bx AND By."""
    return bf_size_swamidass(row_x & row_y, num_hashes)


def bf_intersection_and_from_ones(ones: torch.Tensor, total_bits: int,
                                  num_hashes: int) -> torch.Tensor:
    """Eq. 2 given a precomputed popcount (e.g. from the CUDA kernel)."""
    ones = torch.clamp(ones.to(torch.float32), max=total_bits - 1)
    return -(total_bits / num_hashes) * torch.log1p(-ones / total_bits)


def bf_intersection_limit(row_x: torch.Tensor, row_y: torch.Tensor,
                          num_hashes: int) -> torch.Tensor:
    """|X∩Y|_L (Eq. 4): ones(AND)/b — the B→∞ limit of the AND estimator."""
    return _popcount_words(row_x & row_y).to(torch.float32) / num_hashes


def bf_intersection_or(row_x: torch.Tensor, row_y: torch.Tensor,
                       num_hashes: int, size_x: torch.Tensor,
                       size_y: torch.Tensor) -> torch.Tensor:
    """|X∩Y|_OR (Eq. 29): |X|+|Y| - |X∪Y|_S via OR."""
    union_est = bf_size_swamidass(row_x | row_y, num_hashes)
    return size_x.to(torch.float32) + size_y.to(torch.float32) - union_est


def bf_false_positive_rate(row: torch.Tensor, num_hashes: int) -> torch.Tensor:
    """p_f = (ones/B)^b — per-sketch false-positive probability."""
    total_bits = row.shape[-1] * 32
    frac = _popcount_words(row).to(torch.float32) / total_bits
    return frac ** num_hashes


# ----------------------------------------------------------------------------
# k-Hash MinHash (Eq. 5)
# ----------------------------------------------------------------------------

def _rowwise(name: str, a: torch.Tensor, b: torch.Tensor, sentinel: int,
             use_kernel: Optional[bool]) -> torch.Tensor:
    """Apply the int32[E, k] x int32[E, k] -> int32[E] count ``ops.<name>``
    to ``[..., k]`` rows (lazy import: ``repro_torch.kernels`` imports
    this module)."""
    from ..kernels import ops

    lead, k = a.shape[:-1], a.shape[-1]
    out = getattr(ops, name)(a.reshape(-1, k), b.reshape(-1, k), sentinel,
                             use_kernel=use_kernel)
    return out.reshape(lead)


def khash_jaccard(mx: torch.Tensor, my: torch.Tensor, n: int, *,
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Ĵ_kH = |M_X ∩ M_Y| / k with multiset (per-hash-function) alignment."""
    k = mx.shape[-1]
    matches = _rowwise("khash_match_pairs", mx, my, n, use_kernel)
    return matches.to(torch.float32) / k


def minhash_intersection(j_hat: torch.Tensor, size_x: torch.Tensor,
                         size_y: torch.Tensor) -> torch.Tensor:
    """|X∩Y| = Ĵ/(1+Ĵ) · (|X|+|Y|)  (Eq. 5 and the 1-Hash analogue)."""
    s = size_x.to(torch.float32) + size_y.to(torch.float32)
    return j_hat / (1.0 + j_hat) * s


def khash_intersection(mx: torch.Tensor, my: torch.Tensor, size_x, size_y,
                       n: int, *, use_kernel: Optional[bool] = None
                       ) -> torch.Tensor:
    """|X∩Y| from the k-Hash Jaccard estimate and the exact sizes."""
    return minhash_intersection(
        khash_jaccard(mx, my, n, use_kernel=use_kernel), size_x, size_y)


# ----------------------------------------------------------------------------
# 1-Hash MinHash (paper §IV-D)
# ----------------------------------------------------------------------------

def _sorted_intersect_count(a: torch.Tensor, b: torch.Tensor, sentinel: int,
                            *, use_kernel: Optional[bool] = None
                            ) -> torch.Tensor:
    """|set(a) ∩ set(b)| for sentinel-padded, duplicate-free rows: the k²
    compare count of ``ops.mh_intersect_pairs``."""
    return _rowwise("mh_intersect_pairs", a, b, sentinel, use_kernel)


def onehash_jaccard_naive(mx: torch.Tensor, my: torch.Tensor, n: int, *,
                          use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Paper's literal Ĵ_1H = |M¹_X ∩ M¹_Y| / k."""
    k = mx.shape[-1]
    return _sorted_intersect_count(mx, my, n, use_kernel=use_kernel
                                   ).to(torch.float32) / k


def onehash_jaccard_union(mx: torch.Tensor, my: torch.Tensor,
                          hx: torch.Tensor, hy: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Union-k-min Ĵ_1H: among the k smallest hashes of X∪Y (merged from the
    two sketches), the fraction present in both sketches.

    mx/my are 1-Hash sketches sorted by hash; hx/hy their hash values
    (int64 holding uint32, pads ``PAD_HASH``). The stable argsort breaks
    hash ties by position, as the reference's does.
    """
    k = mx.shape[-1]
    elems = torch.cat([mx, my], dim=-1)
    dup = _pairwise_dup_mask(mx, my, n)
    hsh = torch.where(torch.cat([torch.zeros_like(dup), dup], dim=-1),
                      PAD_HASH, torch.cat([hx, hy], dim=-1))
    order = torch.argsort(hsh, dim=-1, stable=True)
    top_h = torch.gather(hsh, -1, order)[..., :k]
    top_e = torch.gather(elems, -1, order)[..., :k]
    top_e = torch.where(top_h == PAD_HASH, n, top_e)
    in_x = _membership(top_e, mx, n)
    in_y = _membership(top_e, my, n)
    denom = torch.clamp(torch.sum(top_e < n, dim=-1), min=1)
    return (torch.sum(in_x & in_y, dim=-1).to(torch.float32)
            / denom.to(torch.float32))


def _pairwise_dup_mask(mx: torch.Tensor, my: torch.Tensor,
                       n: int) -> torch.Tensor:
    """For each element of my, is it also present in mx?"""
    eq = my[..., :, None] == mx[..., None, :]
    valid = (my[..., :, None] < n) & (mx[..., None, :] < n)
    return torch.any(eq & valid, dim=-1)


def _membership(queries: torch.Tensor, table: torch.Tensor,
                n: int) -> torch.Tensor:
    eq = queries[..., :, None] == table[..., None, :]
    valid = (queries[..., :, None] < n) & (table[..., None, :] < n)
    return torch.any(eq & valid, dim=-1)


def onehash_intersection(mx, my, hx, hy, size_x, size_y, n: int,
                         variant: str = "union", *,
                         use_kernel: Optional[bool] = None) -> torch.Tensor:
    """|X∩Y| from a 1-Hash Jaccard estimate ("union" or "naive") and the
    exact sizes; ``hx``/``hy`` are read by the union variant only."""
    if variant == "naive":
        j = onehash_jaccard_naive(mx, my, n, use_kernel=use_kernel)
    else:
        j = onehash_jaccard_union(mx, my, hx, hy, n)
    return minhash_intersection(j, size_x, size_y)


# ----------------------------------------------------------------------------
# KMV (paper §IX, App. G)
# ----------------------------------------------------------------------------

def kmv_size(kmv_row: torch.Tensor) -> torch.Tensor:
    """|X|_K = (k-1)/max(K_X) (Eq. 39); handles partially-filled sketches."""
    present = kmv_row < KMV_PAD
    filled = torch.sum(present, dim=-1)
    kmax = torch.amax(torch.where(present, kmv_row, 0.0), dim=-1)
    est = (filled.to(torch.float32) - 1.0) / torch.clamp(kmax, min=1e-20)
    # if the sketch isn't full, it IS the whole set: |X| = filled
    full = filled >= kmv_row.shape[-1]
    return torch.where(full, est, filled.to(torch.float32))


def kmv_union_size(kx: torch.Tensor, ky: torch.Tensor) -> torch.Tensor:
    """|X∪Y|_K from the k smallest of K_X ∪ K_Y (dedup by hash value)."""
    k = kx.shape[-1]
    merged = torch.sort(torch.cat([kx, ky], dim=-1), dim=-1).values
    # dedupe equal adjacent values (same element hashed in both sets)
    dup = torch.cat([torch.zeros_like(merged[..., :1], dtype=torch.bool),
                     merged[..., 1:] == merged[..., :-1]], dim=-1)
    merged = torch.where(dup & (merged < KMV_PAD), KMV_PAD, merged)
    merged = torch.sort(merged, dim=-1).values[..., :k]
    return kmv_size(merged)


def kmv_intersection(kx: torch.Tensor, ky: torch.Tensor, size_x,
                     size_y) -> torch.Tensor:
    """|X∩Y|_K = |X| + |Y| - |X∪Y|_K (Eq. 41, exact degrees known)."""
    union = kmv_union_size(kx, ky)
    est = size_x.to(torch.float32) + size_y.to(torch.float32) - union
    return torch.clamp(est, min=0.0)


# ----------------------------------------------------------------------------
# Uniform pair-estimator dispatch (used by algorithms & benchmarks)
# ----------------------------------------------------------------------------

def pair_estimator(kind: str):
    """Returns fn(sketch_rows_u, sketch_rows_v, deg_u, deg_v, ctx) -> float32.

    ``ctx`` holds ``num_hashes`` (Bloom), ``n`` (MinHash sentinel),
    ``hash_of`` and optionally ``variant`` (1-Hash). MinHash counts follow
    the tensors' device.
    """
    def bf_and(ru, rv, du, dv, ctx):
        return bf_intersection_and(ru, rv, ctx["num_hashes"])

    def bf_l(ru, rv, du, dv, ctx):
        return bf_intersection_limit(ru, rv, ctx["num_hashes"])

    def bf_or(ru, rv, du, dv, ctx):
        return bf_intersection_or(ru, rv, ctx["num_hashes"], du, dv)

    def kh(ru, rv, du, dv, ctx):
        return khash_intersection(ru, rv, du, dv, ctx["n"])

    def oneh(ru, rv, du, dv, ctx):
        hx = ctx["hash_of"](ru)
        hy = ctx["hash_of"](rv)
        return onehash_intersection(ru, rv, hx, hy, du, dv, ctx["n"],
                                    ctx.get("variant", "union"))

    def kmv(ru, rv, du, dv, ctx):
        return kmv_intersection(ru, rv, du, dv)

    table = {"bf": bf_and, "bf_and": bf_and, "bf_l": bf_l, "bf_or": bf_or,
             "kh": kh, "1h": oneh, "kmv": kmv}
    return table[kind]
