"""Set-expression IR and its compiler to the popcount kernels (SISA layer).

A tiny IR of :class:`SetExpr` nodes (k-way ``AND``/``OR``/``ANDNOT`` over
sketch rows, implicitly popcount-reduced) and a compiler that turns any
tree, once, into a postfix :class:`~repro_torch.kernels.program.Program`.
The program runs in one fused pass of the CUDA kernels
(:mod:`repro_torch.kernels.fused_expr`): per tuple, gather every
referenced sketch row, evaluate the program in registers, popcount. The
plain PyTorch version runs the same program on gathered rows, so the two
lowerings share one source of truth and give identical popcounts.

The IR is the reference's (``repro.engine.setexpr``), copied. Usage::

    from repro_torch.engine import setexpr
    u, v, w = setexpr.rows(3)
    ce = setexpr.compile_expr((u & v) - w)       # |N_u ∩ N_v ∖ bits(B_w)|
    ones = ce.ones(sketch.data, tuples)          # int32[T] popcounts
    size = ce.cardinality(sketch, tuples)        # Swamidass estimate
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..kernels import fused_expr, ref
from ..kernels.program import AND, ANDNOT, OR, PUSH, Program
from ..obs import trace
from ..obs.metrics import REGISTRY


# ----------------------------------------------------------------------------
# the IR
# ----------------------------------------------------------------------------

class SetExpr:
    """Base class of set-algebra expression nodes over sketch rows.

    Supports operator sugar: ``a & b`` (intersection/AND), ``a | b``
    (union/OR), ``a - b`` (difference/ANDNOT). Expressions are immutable
    and hash by structure, which is what the compile cache keys on.
    """

    def __and__(self, other: "SetExpr") -> "SetExpr":
        """k-way AND; chains flatten (``a & b & c`` is one 3-way node)."""
        return and_all(self, other)

    def __or__(self, other: "SetExpr") -> "SetExpr":
        """k-way OR; chains flatten like AND."""
        return or_all(self, other)

    def __sub__(self, other: "SetExpr") -> "SetExpr":
        """Set difference lowered as ANDNOT: ``a & ~b`` on the bit rows."""
        return AndNot(self, other)

    def key(self) -> tuple:
        """Canonical structure key (nested tuples) — the cache identity."""
        raise NotImplementedError

    def __hash__(self) -> int:
        return hash(self.key())

    def __eq__(self, other) -> bool:
        return isinstance(other, SetExpr) and self.key() == other.key()


class Row(SetExpr):
    """A leaf: the sketch row of tuple column ``slot`` (0-based)."""

    def __init__(self, slot: int):
        if slot < 0:
            raise ValueError("Row slot must be >= 0")
        self.slot = int(slot)

    def key(self) -> tuple:
        """``("row", slot)``."""
        return ("row", self.slot)

    def __repr__(self) -> str:
        return f"Row({self.slot})"


class _NAry(SetExpr):
    """Internal k-way node (``op`` is "and" | "or"); built via the
    :func:`and_all` / :func:`or_all` constructors, which flatten chains."""

    def __init__(self, op: str, args: Tuple[SetExpr, ...]):
        self.op = op
        self.args = args

    def key(self) -> tuple:
        """``(op, child_key, ...)``."""
        return (self.op, *(a.key() for a in self.args))

    def __repr__(self) -> str:
        sep = " & " if self.op == "and" else " | "
        return "(" + sep.join(map(repr, self.args)) + ")"


class AndNot(SetExpr):
    """Binary difference node: bits of ``a`` with ``b``'s bits cleared."""

    def __init__(self, a: SetExpr, b: SetExpr):
        self.a = a
        self.b = b

    def key(self) -> tuple:
        """``("andnot", a_key, b_key)``."""
        return ("andnot", self.a.key(), self.b.key())

    def __repr__(self) -> str:
        return f"({self.a!r} - {self.b!r})"


def rows(k: int) -> Tuple[Row, ...]:
    """The first ``k`` leaf rows — ``rows(3)`` ≡ ``(Row(0), Row(1), Row(2))``."""
    return tuple(Row(i) for i in range(k))


def _flatten(op: str, args: Sequence[SetExpr]) -> Tuple[SetExpr, ...]:
    out: list[SetExpr] = []
    for a in args:
        if isinstance(a, _NAry) and a.op == op:
            out.extend(a.args)
        else:
            out.append(a)
    return tuple(out)


def and_all(*args: SetExpr) -> SetExpr:
    """k-way AND of the given expressions (nested ANDs flatten)."""
    flat = _flatten("and", args)
    return flat[0] if len(flat) == 1 else _NAry("and", flat)


def or_all(*args: SetExpr) -> SetExpr:
    """k-way OR of the given expressions (nested ORs flatten)."""
    flat = _flatten("or", args)
    return flat[0] if len(flat) == 1 else _NAry("or", flat)


def expr_slots(expr: SetExpr) -> Tuple[int, ...]:
    """Sorted distinct tuple columns the expression reads (its leaves)."""
    found: set[int] = set()

    def walk(e: SetExpr) -> None:
        """Collect leaf slots depth-first."""
        if isinstance(e, Row):
            found.add(e.slot)
        elif isinstance(e, _NAry):
            for a in e.args:
                walk(a)
        elif isinstance(e, AndNot):
            walk(e.a)
            walk(e.b)
        else:  # pragma: no cover - new node kinds must extend the walker
            raise TypeError(f"unknown SetExpr node {type(e).__name__}")

    walk(expr)
    return tuple(sorted(found))


# ----------------------------------------------------------------------------
# the compiler
# ----------------------------------------------------------------------------

def compile_program(expr: SetExpr) -> Program:
    """Lower a tree to its postfix program (leaves in sorted-slot order).

    Raises ``ValueError`` beyond the kernels' limits (16 instructions, 8
    distinct leaves).
    """
    slots = expr_slots(expr)
    if not slots:
        raise ValueError("expression references no Row leaves")
    pos = {s: i for i, s in enumerate(slots)}
    ops: List[int] = []
    args: List[int] = []

    def emit(e: SetExpr) -> None:
        """Post-order emission: operands first, then the operator."""
        if isinstance(e, Row):
            ops.append(PUSH)
            args.append(pos[e.slot])
        elif isinstance(e, _NAry):
            emit(e.args[0])
            for a in e.args[1:]:
                emit(a)
                ops.append(AND if e.op == "and" else OR)
                args.append(0)
        elif isinstance(e, AndNot):
            emit(e.a)
            emit(e.b)
            ops.append(ANDNOT)
            args.append(0)
        else:
            raise TypeError(f"unknown SetExpr node {type(e).__name__}")

    emit(expr)
    return Program(ops=tuple(ops), args=tuple(args), slots=slots)


class CompiledSetExpr:
    """One expression compiled to a program for the fused popcount pass.

    Instances come from :func:`compile_expr`, which caches them by
    expression structure, block shapes and dispatch. Two input forms:

      * :meth:`ones` — *gather* form: sketch matrix + int32[T, >max_slot]
        tuple array; each leaf ``Row(s)`` reads the row indexed by tuple
        column ``s``.
      * :meth:`ones_rows` — *dense* form: one int32[E, W] operand matrix
        per distinct leaf slot, in sorted-slot order.

    ``use_kernel=True`` launches the CUDA kernel and needs CUDA tensors;
    ``False`` runs the plain PyTorch version on whatever device the
    tensors are on. The kernels take any tuple count and row width, so
    nothing is padded.
    """

    def __init__(self, expr: SetExpr, *, block_e: int, block_w: int,
                 use_kernel: bool):
        self.expr = expr
        self.program = compile_program(expr)
        self.slots = self.program.slots
        self.arity = len(self.slots)
        self.block_e = int(block_e)
        self.block_w = int(block_w)
        self.use_kernel = bool(use_kernel)

    def _require_cuda(self, x: torch.Tensor) -> None:
        if self.use_kernel and not x.is_cuda:
            raise ValueError(
                "use_kernel=True needs CUDA tensors; the plain PyTorch path "
                "is use_kernel=False")

    # -- gather form --------------------------------------------------------

    def ones(self, data: torch.Tensor, tuples: torch.Tensor) -> torch.Tensor:
        """Evaluate over gathered sketch rows: int32[T] popcounts.

        Args:
          data:   int32[n, W] sketch matrix (e.g. ``SketchSet.data``).
          tuples: int32[T, k] row-index tuples; leaf ``Row(s)`` reads
                  column ``s`` (k must exceed the largest referenced slot).
        """
        tuples = torch.as_tensor(tuples, device=data.device).to(torch.int32)
        if tuples.shape[0] == 0:
            return torch.zeros((0,), dtype=torch.int32, device=data.device)
        if tuples.shape[1] <= self.slots[-1]:
            raise ValueError(
                f"expression reads tuple column {self.slots[-1]} but tuples "
                f"have width {tuples.shape[1]}")
        self._require_cuda(data)
        if self.use_kernel:
            return fused_expr.fused_gather_popcount(data, tuples, self.program)
        return ref.fused_gather_popcount(data, tuples, self.program)

    def cardinality(self, sketch, tuples: torch.Tensor) -> torch.Tensor:
        """Swamidass size estimate of the expression row per tuple."""
        from ..core import estimators as est
        return est.bf_intersection_and_from_ones(
            self.ones(sketch.data, tuples), sketch.total_bits,
            sketch.num_hashes)

    # -- dense form ---------------------------------------------------------

    def ones_rows(self, *rows: torch.Tensor) -> torch.Tensor:
        """Evaluate over dense operand matrices: int32[E] popcounts.

        Args:
          *rows: one int32[E, W] matrix per distinct leaf slot, in sorted
                 slot order (``Row(0)``'s operand first).
        """
        if len(rows) != self.arity:
            raise ValueError(
                f"expression has {self.arity} distinct leaves, got "
                f"{len(rows)} operand matrices")
        if rows[0].shape[0] == 0:
            return torch.zeros((0,), dtype=torch.int32, device=rows[0].device)
        self._require_cuda(rows[0])
        if self.use_kernel:
            return fused_expr.fused_rows_popcount(rows, self.program)
        return ref.fused_rows_popcount(rows, self.program)

    def __repr__(self) -> str:
        return (f"CompiledSetExpr({self.expr!r}, block_e={self.block_e}, "
                f"block_w={self.block_w}, use_kernel={self.use_kernel})")


# the shared compile cache: expression structure + block shapes + dispatch
_CACHE: Dict[tuple, CompiledSetExpr] = {}
_CACHE_HITS = 0


def compile_expr(expr: SetExpr, *, block_e: int = 8, block_w: int = 512,
                 use_kernel: bool = True) -> CompiledSetExpr:
    """Compile (with caching) a set expression to a fused popcount pass.

    Args:
      expr:       the expression tree (see :func:`rows` and the operators).
      block_e:    kept for plan parity with the reference; the CUDA kernels
                  ignore it.
      block_w:    likewise.
      use_kernel: launch the CUDA kernel (CUDA tensors only); ``False``
                  runs the plain PyTorch version (identical ints).

    Returns:
      The cached :class:`CompiledSetExpr` for this structure/configuration.
    """
    global _CACHE_HITS
    key = (expr.key(), int(block_e), int(block_w), bool(use_kernel))
    hit = _CACHE.get(key)
    if hit is not None:
        _CACHE_HITS += 1
        REGISTRY.counter("setexpr_compile_total", result="hit").inc()
        return hit
    with trace.span("setexpr.compile", expr=repr(expr)):
        ce = CompiledSetExpr(expr, block_e=block_e, block_w=block_w,
                             use_kernel=use_kernel)
    REGISTRY.counter("setexpr_compile_total", result="miss").inc()
    _CACHE[key] = ce
    return ce


def cache_info() -> dict:
    """Compile-cache counters: distinct compiled expressions and hits."""
    return {"size": len(_CACHE), "hits": _CACHE_HITS}


def cache_clear() -> None:
    """Drop every cached compiled expression (mainly for tests)."""
    global _CACHE_HITS
    _CACHE.clear()
    _CACHE_HITS = 0


__all__ = [
    "AndNot", "CompiledSetExpr", "Row", "SetExpr", "and_all", "cache_clear",
    "cache_info", "compile_expr", "compile_program", "expr_slots", "or_all",
    "rows",
]
