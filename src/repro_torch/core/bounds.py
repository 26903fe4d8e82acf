"""Concentration / MSE bounds from the paper (host-side, numpy floats).

These make the accuracy knob *quantitative*: given sketch parameters, they
bound P(|estimate - truth| >= t). Used by tests (empirical deviations must sit
inside the bounds) and by the auto-tuner that picks sketch sizes for a target
accuracy (data-pipeline dedup uses Prop IV.2 to size k). The reference's
``core/bounds.py``, copied: it is numpy only.
"""
from __future__ import annotations

import numpy as np


def _bf_and_mse(inter_size, total_bits: int, num_hashes: int) -> np.ndarray:
    """Prop IV.1 MSE expression, vectorized over the intersection size —
    the single home of the formula (scalar bound and streaming RMSE scale
    both derive from it, so a correction lands in both)."""
    B, b = float(total_bits), float(num_hashes)
    c = np.asarray(inter_size, dtype=np.float64)
    return np.exp(c * b / (B - 1.0)) * B / b**2 - B / b**2 - c / b


def bf_and_mse_bound(inter_size: float, total_bits: int, num_hashes: int) -> float:
    """Prop IV.1: MSE upper bound for |X∩Y|_AND (up to the (1+o(1)) factor).

    Valid when b = o(sqrt(B)) and b·|X∩Y| <= 0.499·B·log(B).
    """
    return float(_bf_and_mse(inter_size, total_bits, num_hashes))


def bf_kway_and_mse_bound(inter_size: float, total_bits: int,
                          num_hashes: int, k: int = 2) -> float:
    """MSE bound for the *direct* k-way AND estimator |X_1∩…∩X_k|_AND.

    The Swamidass map applied to popcount(B_1 AND … AND B_k) sees exactly
    one derived Bloom row whose true-bit process is governed by the k-way
    intersection size, so Prop IV.1's MSE expression carries over with
    ``inter_size`` the k-way intersection (the AND row's ones are
    stochastically *closer* to the true-bits-only row as k grows — each
    extra AND strips false-positive bits that survive the pairwise case —
    so this is conservative for k > 2). Validity mirrors the pairwise
    bound: b = o(sqrt(B)) and b·|∩| <= 0.499·B·log(B).

    This is why ``repro_torch.engine.setexpr`` lowers k-way queries (e.g.
    the 5-clique 4-way AND) to a *single* fused AND expression instead of
    inclusion–exclusion over the 2^k − 1 pairwise/union terms: the direct
    estimator needs one popcount with one MSE of this form, while the
    inclusion–exclusion expansion sums 2^k − 1 estimates whose errors add
    (in the best, independent case) and whose alternating signs lose the
    intersection's monotonicity — the kH 3-way path in
    ``core.algorithms.cliques`` shows the degradation in practice.
    """
    if k < 2:
        raise ValueError(f"k-way AND needs k >= 2, got {k}")
    return float(_bf_and_mse(inter_size, total_bits, num_hashes))


def bf_and_deviation_bound(inter_size: float, total_bits: int, num_hashes: int,
                           t: float) -> float:
    """Eq. 3: Chebyshev-on-MSE tail bound P(|est−truth| ≥ t)."""
    if t <= 0:
        return 1.0
    return min(1.0, bf_and_mse_bound(inter_size, total_bits, num_hashes) / t**2)


def bf_linear_mse_bound(set_size: float, total_bits: int, num_hashes: int,
                        delta: float | None = None) -> float:
    """Prop A.2: exact (assumption-free) MSE bound for linear estimators
    δ·B_{X,1}; δ defaults to 1/b (the |X|_L / |X∩Y|_L estimator)."""
    B, b, c = float(total_bits), float(num_hashes), float(set_size)
    d = (1.0 / b) if delta is None else float(delta)
    lam = c * b / B
    bias2 = (c - d * B * (1.0 - np.exp(-lam))) ** 2
    var = d**2 * B * (np.exp(-lam) - (1.0 + lam) * np.exp(-2.0 * lam))
    return float(bias2 + var)


def bf_linear_deviation_bound(set_size: float, total_bits: int, num_hashes: int,
                              t: float, delta: float | None = None) -> float:
    if t <= 0:
        return 1.0
    return min(1.0, bf_linear_mse_bound(set_size, total_bits, num_hashes, delta) / t**2)


def minhash_deviation_bound(size_x: float, size_y: float, k: int, t: float) -> float:
    """Prop IV.2 / IV.3 (identical form): exponential tail for kH and 1H,
    P(| |X∩Y|_MH − |X∩Y| | ≥ t) ≤ 2·exp(−2kt² / (|X|+|Y|)²)."""
    if t <= 0:
        return 1.0
    s = float(size_x) + float(size_y)
    if s == 0:
        return 0.0
    return min(1.0, 2.0 * np.exp(-2.0 * k * t**2 / s**2))


def bf_and_rmse(inter_size, total_bits: int, num_hashes: int) -> np.ndarray:
    """Vectorized RMSE form of Prop IV.1 (clamped to 0 outside validity).

    Streaming maintenance uses this as the BF sketch's intrinsic error scale:
    staleness from deferred deletions that stays below it is statistically
    invisible, so rebuilds can wait (the error-budget policy).
    """
    return np.sqrt(np.maximum(
        _bf_and_mse(inter_size, total_bits, num_hashes), 0.0))


def minhash_error_scale(set_size, k: int, delta: float = 0.05) -> np.ndarray:
    """Invert Prop IV.2 at fixed k: smallest t whose deviation probability is
    ≤ delta for a pair of sets of the given size (vectorized over sizes).

    t = (|X|+|Y|)·sqrt(ln(2/δ) / 2k); with |X| = |Y| = set_size this is the
    MinHash/KMV analogue of :func:`bf_and_rmse` for the streaming
    error-budget policy.
    """
    s = 2.0 * np.asarray(set_size, dtype=np.float64)
    return s * np.sqrt(np.log(2.0 / float(delta)) / (2.0 * max(int(k), 1)))


def minhash_k_for_accuracy(size_x: float, size_y: float, t: float, delta: float) -> int:
    """Invert Prop IV.2: smallest k with deviation ≥t having prob ≤ delta."""
    s = float(size_x) + float(size_y)
    if t <= 0 or s == 0:
        return 1
    return int(np.ceil(s**2 * np.log(2.0 / delta) / (2.0 * t**2)))


# ---------------------------------------------------------------------------
# Triangle-count bounds (Theorem VII.1)
# ---------------------------------------------------------------------------

def tc_bf_deviation_bound(m: int, max_degree: int, total_bits: int,
                          num_hashes: int, t: float) -> float:
    """Thm VII.1, BF case. Valid when b·Δ ≤ 0.499·B·log(B)."""
    if t <= 0:
        return 1.0
    mse = float(_bf_and_mse(max_degree, total_bits, num_hashes))
    return min(1.0, 2.0 * m**2 * mse / (9.0 * t**2))


def tc_minhash_deviation_bound(degrees: np.ndarray, k: int, t: float) -> float:
    """Thm VII.1, MinHash case: 2·exp(−18kt² / (Σ d(v)²)²)."""
    if t <= 0:
        return 1.0
    s2 = float(np.sum(np.asarray(degrees, dtype=np.float64) ** 2))
    if s2 == 0:
        return 0.0
    return min(1.0, 2.0 * np.exp(-18.0 * k * t**2 / s2**2))


def tc_minhash_deviation_bound_bounded_degree(degrees: np.ndarray, k: int, t: float) -> float:
    """Thm VII.1, tighter MinHash bound via Vizing grouping:
    2·exp(−9kt² / (4(Δ+1)·Σ d(v)³))."""
    if t <= 0:
        return 1.0
    d = np.asarray(degrees, dtype=np.float64)
    s3 = float(np.sum(d**3))
    if s3 == 0:
        return 0.0
    delta = float(d.max())
    return min(1.0, 2.0 * np.exp(-9.0 * k * t**2 / (4.0 * (delta + 1.0) * s3)))


# ---------------------------------------------------------------------------
# Sweep-cut conductance bounds (local clustering; Prop IV.1 accumulated)
# ---------------------------------------------------------------------------

def sweep_cut_rmse(prefix_degrees: np.ndarray, total_bits: int,
                   num_hashes: int) -> np.ndarray:
    """Cumulative RMSE of the sketch-gated sweep *cut* after each step.

    Step j of a sweep estimates ``|N(v_j) ∩ S_{j-1}|`` by inclusion–exclusion
    (both set sizes are known exactly, only ``|N(v_j) ∪ S_{j-1}|`` is
    estimated from the OR of the two filters), so the step error is the
    Swamidass size-estimator error at the *union* size ``d(v_j) + j`` — the
    Prop IV.1 MSE expression evaluated there, which correctly explodes as
    the prefix filter saturates. Each estimate enters the running cut with
    weight 2, and consecutive steps share the growing prefix filter, so
    their errors *correlate* —
    the right accumulation is the sum of per-step RMSEs (worst case under
    arbitrary correlation), not the independent-errors square root:

        err_scale(cut_j) = 2 · Σ_{i≤j} RMSE(d(v_i) + i)

    (empirically the observed drift tracks this sum; the sqrt-of-variances
    form underestimates it by >5× on Kronecker sweeps). ``prefix_degrees``
    is the degree sequence in sweep order; returns the vector of cumulative
    cut error scales (one per prefix). Divide by
    ``min(vol(S_j), vol(V∖S_j))`` for the conductance error scale.
    """
    degs = np.asarray(prefix_degrees, dtype=np.float64)
    union = degs + np.arange(degs.size, dtype=np.float64)
    mse = np.maximum(_bf_and_mse(union, total_bits, num_hashes), 0.0)
    return 2.0 * np.cumsum(np.sqrt(mse))


def sweep_conductance_interval(prefix_degrees: np.ndarray, volumes: np.ndarray,
                               total_bits: int, num_hashes: int,
                               delta: float = 0.05) -> np.ndarray:
    """Half-width of a (1−δ) Chebyshev interval on each prefix's conductance.

    ``|φ_est(S_j) − φ(S_j)| ≤ RMSE(cut_j) / (sqrt(δ)·denom_j)`` with
    probability ≥ 1−δ, where ``denom_j = min(vol(S_j), 2m − vol(S_j))``
    passed in as ``volumes``. Vectorized over prefixes.
    """
    rmse = sweep_cut_rmse(prefix_degrees, total_bits, num_hashes)
    denom = np.maximum(np.asarray(volumes, dtype=np.float64), 1.0)
    return rmse / (np.sqrt(float(delta)) * denom)


def bloom_words_for_conductance(target_err: float, typical_degree: float,
                                sweep_len: int, volume: float,
                                num_hashes: int = 2, delta: float = 0.05,
                                max_words: int = 1 << 16) -> int:
    """Smallest Bloom words/vertex whose sweep conductance error ≤ target.

    Inverts :func:`sweep_conductance_interval` at a homogeneous model sweep
    (``sweep_len`` steps, every step at ``typical_degree``, denominator
    ``volume``) by doubling the word count until the (1−δ) interval half-width
    at the *last* prefix — the worst one, errors only accumulate — drops
    under ``target_err``. The streaming/serving path uses this to size the
    sketch from a conductance-error budget instead of a storage budget.

    Raises ``ValueError`` when even ``max_words`` cannot meet the target
    (rather than silently returning an undersized sketch) — shorten the
    sweep, raise δ, or relax the target.
    """
    degs = np.full(max(int(sweep_len), 1), float(typical_degree))
    words = 2
    while True:
        half = sweep_conductance_interval(
            degs, np.full_like(degs, float(volume)), words * 32, num_hashes,
            delta)[-1]
        if half <= target_err:
            return int(words)
        if words >= max_words:
            raise ValueError(
                f"target conductance error {target_err} unreachable at "
                f"max_words={max_words} (half-width {half:.3g}); shorten "
                "the sweep, raise delta, or relax the target")
        words *= 2


# ---------------------------------------------------------------------------
# KMV bounds (Prop A.7 / A.9) — regularized incomplete beta via series
# ---------------------------------------------------------------------------

def _reg_inc_beta_int(x: float, k: int, n: int) -> float:
    """I_x(k, n-k+1) = P(Bin(n, x) >= k), exact binomial-sum form."""
    if x <= 0:
        return 0.0
    if x >= 1:
        return 1.0
    # sum_{i=k}^{n} C(n,i) x^i (1-x)^{n-i}, computed in log space
    from math import lgamma as _lg
    lx, l1x = np.log(x), np.log1p(-x)
    total = 0.0
    for i in range(k, n + 1):
        logp = _lg(n + 1) - _lg(i + 1) - _lg(n - i + 1) + i * lx + (n - i) * l1x
        total += np.exp(logp)
    return float(min(1.0, total))


def kmv_size_containment_prob(set_size: int, k: int, t: float) -> float:
    """Prop A.7: P(| |X|_K − |X| | ≤ t) for a full KMV sketch."""
    n = int(set_size)
    if n <= k:
        return 1.0  # sketch holds the whole set: exact
    u = min(1.0, (k - 1) / max(n - t, 1e-12))
    l = (k - 1) / (n + t)
    return max(0.0, _reg_inc_beta_int(u, k, n) - _reg_inc_beta_int(l, k, n))


def kmv_intersection_deviation_bound(union_size: int, k: int, t: float) -> float:
    """Prop A.9 (exact-degree variant, Eq. 41): deviation prob of |X∩Y|_K
    equals that of |X∪Y|_K at distance t."""
    return max(0.0, 1.0 - kmv_size_containment_prob(union_size, k, t))
