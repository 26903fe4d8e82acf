"""The numbers that decide ``correct``, each beside its limit.

A job's answers are judged against the plain reference
(``graphbench/reference``): integers (the CSR, sketch words, per-edge
counts, enumeration counts) by how many differ, with the limit 0;
floating-point answers by their largest relative gap, with a limit set
between what sound runs of the program read and what the control (the
reference computed in bfloat16) reads. The limits live in each job
kind's module beside the comparison, with the readings behind them in
``PERF.md``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List

import torch


@dataclasses.dataclass
class Check:
    """One compared number and its limit (the number passes at or under
    the limit; NaN never passes)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return not math.isnan(self.value) and self.value <= self.limit


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Entries of ``got`` that differ from ``want``; every entry of the
    larger when the shapes differ."""
    if tuple(got.shape) != tuple(want.shape):
        return max(got.numel(), want.numel(), 1)
    return int((got.to(want.device, want.dtype) != want).sum())


def relative_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| / |want| over the entries (|got − want| where want
    is 0); inf when the shapes differ or an entry of ``got`` is not
    finite."""
    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    g = got.to(want.device, torch.float64)
    w = want.to(torch.float64)
    if not bool(torch.isfinite(g).all()):
        return math.inf
    if g.numel() == 0:
        return 0.0
    den = torch.where(w == 0, torch.ones_like(w), w.abs())
    return float(((g - w).abs() / den).max())


def merge(checks: Iterable[Check]) -> List[Check]:
    """One check per name, holding the worst value seen under it (NaN is
    the worst)."""
    worst: Dict[str, Check] = {}
    for c in checks:
        prev = worst.get(c.name)
        if prev is None or _rank(c.value) > _rank(prev.value):
            worst[c.name] = c
    return list(worst.values())


def _rank(value: float) -> float:
    return math.inf if math.isnan(value) else value
