"""Scalar expressions pushed down into aggregates.

The port's copy of the JAX package's ``storage/expr.py``. Reference
analog: the pushed-down PgsqlExpressionPB trees evaluated per row inside
the scan (QLExprExecutor, src/yb/common/ql_expr.h:158): the TPC-H Q1/Q6
shapes ``sum(l_extendedprice * (100 - l_discount))`` live here.

Money-like values are scaled integers (cents), so a product expression is
exact integer arithmetic. The device evaluates ``col * f1 [* f2]`` where
each factor is a small-range integer expression (constants and
INT8/INT16/BOOL columns, statically bounded under 2^14); the grouped fold
(``ops.group_agg``) sums the products exactly. The host (the
``Aggregator``) evaluates the same tree in Python integers: the oracle.
"""

from __future__ import annotations

from dataclasses import dataclass

from yugabyte_db_tpu_torch.models.datatypes import DataType


@dataclass(frozen=True)
class Col:
    name: str


@dataclass(frozen=True)
class Const:
    value: int | float  # float constants are host-evaluated only


@dataclass(frozen=True)
class BinOp:
    op: str          # '+', '-', '*'
    left: "Expr"
    right: "Expr"


Expr = Col | Const | BinOp


def eval_expr(expr, get_value):
    """Host evaluation (exact Python ints; None is contagious, as SQL's
    NULL)."""
    if isinstance(expr, Col):
        return get_value(expr.name)
    if isinstance(expr, Const):
        return expr.value
    left = eval_expr(expr.left, get_value)
    right = eval_expr(expr.right, get_value)
    if left is None or right is None:
        return None
    if expr.op == "+":
        return left + right
    if expr.op == "-":
        return left - right
    if expr.op == "*":
        return left * right
    raise ValueError(f"bad op {expr.op}")


def columns_of(expr) -> set[str]:
    if isinstance(expr, Col):
        return {expr.name}
    if isinstance(expr, Const):
        return set()
    return columns_of(expr.left) | columns_of(expr.right)


def bounds(expr, dtype_of) -> tuple[int, int]:
    """Static [lo, hi] interval of an integer expression from the column
    dtypes' ranges (the device's small-factor eligibility check)."""
    if isinstance(expr, Const):
        if not isinstance(expr.value, int) or isinstance(expr.value, bool):
            # Float constants are host-only: the device's factors are
            # exact integers, so lower_product refuses them.
            raise ValueError(f"non-integer constant {expr.value!r}")
        return expr.value, expr.value
    if isinstance(expr, Col):
        dt = dtype_of(expr.name)
        if dt == DataType.BOOL:
            return 0, 1
        if not dt.is_integer:
            raise ValueError(f"non-integer column {expr.name} in expr")
        bits = dt.np_dtype.itemsize * 8
        return -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    llo, lhi = bounds(expr.left, dtype_of)
    rlo, rhi = bounds(expr.right, dtype_of)
    if expr.op == "+":
        return llo + rlo, lhi + rhi
    if expr.op == "-":
        return llo - rhi, lhi - rlo
    cands = (llo * rlo, llo * rhi, lhi * rlo, lhi * rhi)
    return min(cands), max(cands)


def lower_product(expr, dtype_of):
    """Decompose an expression into (base column, [small factor exprs])
    for the device: base * f1 [* f2], where the base is one wide integer
    column and every factor's static bound fits |f| < 2^14 and reads only
    narrow (INT8/INT16/BOOL) columns.

    Returns (base_name, factors), or None when the device cannot take
    the expression."""
    factors = []
    base = None

    def walk(e):
        nonlocal base
        if isinstance(e, BinOp) and e.op == "*":
            walk(e.left)
            walk(e.right)
            return
        if isinstance(e, Col) and dtype_of(e.name).is_integer and \
                dtype_of(e.name).np_dtype.itemsize >= 4:
            if base is not None:
                raise ValueError("two wide columns")
            base = e.name
            return
        factors.append(e)

    try:
        walk(expr)
    except ValueError:
        return None
    if base is None:
        return None  # no wide base column: the host evaluates it
    for f in factors:
        try:
            lo, hi = bounds(f, dtype_of)
        except ValueError:
            return None
        if max(abs(lo), abs(hi)) >= (1 << 14):
            return None
        for cname in columns_of(f):
            if dtype_of(cname).np_dtype.itemsize > 2 and \
                    dtype_of(cname) != DataType.BOOL:
                return None
    if len(factors) > 2:
        return None
    return base, factors
