"""The set-expression program: the data both popcount kernels interpret.

``repro_torch.engine.setexpr`` compiles a ``SetExpr`` tree once into a
postfix :class:`Program` over at most :data:`MAX_LEAVES` distinct leaves
and :data:`MAX_INSTR` instructions. The CUDA kernels receive it by value
in their argument struct, and :func:`eval_program` runs the same program
on torch tensors for the plain versions, so the kernels and their plain
versions share one source of truth for the expression.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence, Tuple

import torch

PUSH, AND, OR, ANDNOT = 0, 1, 2, 3

#: limits fixed by the kernels' argument struct (csrc/fused_expr.cu)
MAX_INSTR = 16
MAX_LEAVES = 8

#: int32 fields of the packed struct: n_instr, n_leaves, and_k, op[16],
#: arg[16], slot[8]
PACKED_INTS = 3 + 2 * MAX_INSTR + MAX_LEAVES


@dataclasses.dataclass(frozen=True)
class Program:
    """A postfix bitwise program over leaf rows.

    Attributes:
      ops:   opcode per instruction (``PUSH``/``AND``/``OR``/``ANDNOT``).
      args:  for ``PUSH``, the leaf index it pushes; 0 otherwise.
      slots: per leaf, the tuple column it reads in the gather form.
    """

    ops: Tuple[int, ...]
    args: Tuple[int, ...]
    slots: Tuple[int, ...]

    def __post_init__(self):
        if len(self.ops) != len(self.args):
            raise ValueError("ops and args differ in length")
        if not 1 <= len(self.slots) <= MAX_LEAVES:
            raise ValueError(
                f"expression reads {len(self.slots)} distinct leaves; the "
                f"kernels take 1 to {MAX_LEAVES}")
        if len(self.ops) > MAX_INSTR:
            raise ValueError(
                f"expression needs {len(self.ops)} instructions; the kernels "
                f"take at most {MAX_INSTR}")
        depth = 0
        for op, arg in zip(self.ops, self.args):
            if op == PUSH:
                if not 0 <= arg < len(self.slots):
                    raise ValueError(f"PUSH of leaf {arg} out of range")
                depth += 1
            elif op in (AND, OR, ANDNOT):
                if depth < 2:
                    raise ValueError("binary op on a stack of fewer than 2")
                depth -= 1
            else:
                raise ValueError(f"unknown opcode {op}")
        if depth != 1:
            raise ValueError("program must leave exactly one value")

    @property
    def n_leaves(self) -> int:
        """Number of distinct leaves (operand rows per tuple)."""
        return len(self.slots)

    @property
    def and_k(self) -> int:
        """K when the program is the AND of leaves 0..K-1 in order (the
        kernels' register fast path), else 0."""
        k = self.n_leaves
        if k < 2:
            return 0
        chain = and_program(k)
        return k if (self.ops, self.args) == (chain.ops, chain.args) else 0

    def packed(self) -> ctypes.Array:
        """The kernels' argument struct as a host int32 array."""
        buf = (ctypes.c_int32 * PACKED_INTS)()
        buf[0], buf[1], buf[2] = len(self.ops), self.n_leaves, self.and_k
        for i, (op, arg) in enumerate(zip(self.ops, self.args)):
            buf[3 + i] = op
            buf[3 + MAX_INSTR + i] = arg
        for j, s in enumerate(self.slots):
            buf[3 + 2 * MAX_INSTR + j] = s
        return buf


def eval_program(program: Program,
                 leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Run ``program`` on int32 word tensors (one per leaf, same shapes)."""
    stack = []
    for op, arg in zip(program.ops, program.args):
        if op == PUSH:
            stack.append(leaves[arg])
            continue
        b = stack.pop()
        a = stack.pop()
        stack.append(a & b if op == AND else a | b if op == OR else a & ~b)
    return stack[0]


def and_program(k: int) -> Program:
    """The k-way AND of tuple columns 0..k-1."""
    ops = (PUSH,) + (PUSH, AND) * (k - 1)
    args = (0,) + sum(((j, 0) for j in range(1, k)), ())
    return Program(ops=ops, args=args, slots=tuple(range(k)))
