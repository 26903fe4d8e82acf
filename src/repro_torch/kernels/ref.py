"""Plain PyTorch versions of the CUDA kernels (their oracles).

The CPU path of every wrapper in :mod:`repro_torch.kernels.fused_expr`,
:mod:`repro_torch.kernels.mh_intersect` and
:mod:`repro_torch.kernels.flash_attention` runs these, and the tests and
``chip_smoke.py`` hold the CUDA kernels against them on the card. Bloom
rows are int32 bit patterns; integer results are exact.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from ..core.estimators import _popcount_words
from .program import Program, and_program, eval_program


def gather_rows(data: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``data[ids]``, with ids clamped to ``[0, n)`` as the kernels do."""
    return data.index_select(0, ids.long().clamp(0, data.shape[0] - 1))


def fused_gather_popcount(data: torch.Tensor, tuples: torch.Tensor,
                          program: Program) -> torch.Tensor:
    """popcount(program(rows of each tuple)): int32[T].

    ``data`` is int32[n, W]; ``tuples`` int32[T, k], leaf j reading column
    ``program.slots[j]``.
    """
    leaves = [gather_rows(data, tuples[:, s]) for s in program.slots]
    return _popcount_words(eval_program(program, leaves))


def fused_segment_popcount(data: torch.Tensor, heads: torch.Tensor,
                           offsets: torch.Tensor,
                           tails: torch.Tensor) -> torch.Tensor:
    """popcount(AND of a segment's head rows and each of its tail rows):
    int32[T]. ``heads`` int32[S, k-1], ``offsets`` [S+1] ascending from 0 to
    T, ``tails`` int32[T]: the heads are repeated over their segments'
    tails and the k-way AND runs as :func:`fused_gather_popcount`."""
    counts = (offsets[1:] - offsets[:-1]).long()
    tuples = torch.cat([heads.repeat_interleave(
        counts, dim=0, output_size=tails.shape[0]), tails[:, None]], dim=1)
    return fused_gather_popcount(data, tuples, and_program(tuples.shape[1]))


def fused_rows_popcount(rows: Sequence[torch.Tensor],
                        program: Program) -> torch.Tensor:
    """popcount(program(dense operand rows)): int32[E], one int32[E, W]
    operand per leaf."""
    return _popcount_words(eval_program(program, list(rows)))


def bf_intersect_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """popcount(a AND b) summed over words. a, b: int32[E, W] -> int32[E]."""
    return _popcount_words(a & b)


def bf_union_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """popcount(a OR b) summed over words (for the OR estimator)."""
    return _popcount_words(a | b)


def bf_intersect3_pairs(a: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor) -> torch.Tensor:
    """popcount(a AND b AND c) (4-clique triple intersections)."""
    return _popcount_words(a & b & c)


def bf_edge_intersect(bloom: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Gather rows u, v from bloom[n, W] per edge and AND-popcount."""
    return bf_intersect_pairs(gather_rows(bloom, edges[:, 0]),
                              gather_rows(bloom, edges[:, 1]))


def bf_edge_intersect3(bloom: torch.Tensor,
                       triples: torch.Tensor) -> torch.Tensor:
    """Gather rows u, v, w from bloom[n, W] per triple and AND-popcount."""
    return bf_intersect3_pairs(gather_rows(bloom, triples[:, 0]),
                               gather_rows(bloom, triples[:, 1]),
                               gather_rows(bloom, triples[:, 2]))


#: compare cells (rows × k × k) one chunk of the plain MinHash count holds
_MH_CHUNK_CELLS = 1 << 26


def mh_intersect_pairs(a: torch.Tensor, b: torch.Tensor,
                       sentinel: int) -> torch.Tensor:
    """Count of (i, j) with ``a[i] == b[j]``, both below ``sentinel``, per
    row of int32[E, k] x int32[E, k] -> int32[E].

    Duplicates count with multiplicity, so for duplicate-free rows this is
    |set(a) ∩ set(b)|. Rows go in chunks of at most ``_MH_CHUNK_CELLS``
    compares, which bounds the k² temporaries.
    """
    e, k = a.shape
    out = torch.zeros(e, dtype=torch.int32, device=a.device)
    step = max(1, _MH_CHUNK_CELLS // max(k * k, 1))
    for s in range(0, e, step):
        x, y = a[s:s + step], b[s:s + step]
        eq = x[:, :, None] == y[:, None, :]
        valid = (x[:, :, None] < sentinel) & (y[:, None, :] < sentinel)
        out[s:s + step] = torch.sum(eq & valid, dim=(1, 2), dtype=torch.int32)
    return out


def khash_match_pairs(a: torch.Tensor, b: torch.Tensor,
                      sentinel: int) -> torch.Tensor:
    """Aligned (per-hash-function) match count for k-Hash sketches:
    positions with ``a == b`` and both below ``sentinel`` -> int32[E]."""
    return torch.sum((a == b) & (a < sentinel) & (b < sentinel), dim=-1,
                     dtype=torch.int32)


def mh_intersect_gather(data: torch.Tensor, pairs: torch.Tensor,
                        sentinel: int) -> torch.Tensor:
    """:func:`mh_intersect_pairs` of rows ``data[u]``, ``data[v]`` per pair
    of int32[E, 2] ``pairs``, ids clamped to ``[0, n)``."""
    return mh_intersect_pairs(gather_rows(data, pairs[:, 0]),
                              gather_rows(data, pairs[:, 1]), sentinel)


def khash_match_gather(data: torch.Tensor, pairs: torch.Tensor,
                       sentinel: int) -> torch.Tensor:
    """:func:`khash_match_pairs` of rows ``data[u]``, ``data[v]`` per pair
    of int32[E, 2] ``pairs``, ids clamped to ``[0, n)``."""
    return khash_match_pairs(gather_rows(data, pairs[:, 0]),
                             gather_rows(data, pairs[:, 1]), sentinel)


#: score cells (batch · heads · queries · keys) one chunk of the plain
#: attention holds in float32 (1 GiB)
_ATTN_CHUNK_CELLS = 1 << 28

#: the reference's masked score
NEG_INF = -1e30


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) attention with an fp32 softmax.

    q: [B, Sq, H, D], k/v: [B, Skv, KV, D] -> [B, Sq, H, D] in q's dtype.
    Query head h reads kv head h // (H / KV); query and key positions both
    start at 0; a key is seen when ``kv_pos <= q_pos`` and, with a window,
    ``kv_pos > q_pos - window``. Masked scores are -1e30, so a row that
    sees no key averages every value, as the reference's softmax does.

    Everything is computed in float32, q scaled by 1/sqrt(D) before the
    product as the TPU kernel does. Queries go in chunks of at most
    ``_ATTN_CHUNK_CELLS`` scores, each against only the keys its band can
    reach, so the function runs at S = 32K.
    """
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    qf = (q.to(torch.float32) * scale).reshape(b, sq, kvh, g, d)
    qf = qf.permute(0, 2, 3, 1, 4)                    # [B, KV, g, Sq, D]
    kf = k.to(torch.float32).permute(0, 2, 3, 1)      # [B, KV, D, Skv]
    vf = v.to(torch.float32).permute(0, 2, 1, 3)      # [B, KV, Skv, D]
    out = torch.empty((b, kvh, g, sq, d), dtype=torch.float32,
                      device=q.device)
    step = max(1, _ATTN_CHUNK_CELLS // max(b * h * skv, 1))
    for s0 in range(0, sq, step):
        s1 = min(sq, s0 + step)
        lo, hi = 0, min(skv, s1)
        if window:
            lo = max(0, s0 - window + 1)
            if s1 - window > skv - 1:          # a row sees no key
                lo, hi = 0, skv
        c = s1 - s0
        qc = qf[:, :, :, s0:s1].reshape(b, kvh, g * c, d)
        sc = torch.matmul(qc, kf[..., lo:hi]).reshape(b, kvh, g, c, hi - lo)
        qpos = torch.arange(s0, s1, device=q.device)[:, None]
        kpos = torch.arange(lo, hi, device=q.device)[None, :]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        sc = torch.where(mask, sc, NEG_INF).softmax(dim=-1)
        out[:, :, :, s0:s1] = torch.matmul(
            sc.reshape(b, kvh, g * c, hi - lo), vf[:, :, lo:hi]
        ).reshape(b, kvh, g, c, d)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def flash_attention_folded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, groups: int,
                           window: int = 0) -> torch.Tensor:
    """:func:`causal_attention` on the folded layout: q [BH, Sq, D], k/v
    [BKV, Skv, D] with BH = BKV · groups, head i reading kv head
    i // groups -> [BH, Sq, D]."""
    out = causal_attention(q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                           v.transpose(0, 1)[None], window)
    return out[0].transpose(0, 1).contiguous()
