"""Numeric/symbolic dispatch for the scalar op semantics used in IR replay.

Each ``apply_*`` function executes the op numerically for plain numbers and
routes symbolic values (tracer variables) back into the trace graph.
Counterpart of ``da4ml_tpu/ops/numeric.py``.
"""

from __future__ import annotations

from math import floor, log2

import numpy as np

from ..ir.types import QInterval, minimal_kif, quantize_float, relu_float

_NUMERIC = (int, float, np.integer, np.floating)


def _interpret_as(x: int, k, i, f) -> float:
    b = int(k) + i + f
    bias = 2.0 ** (b - 1) * int(k)
    eps = 2.0**-f
    return eps * (floor(x + bias) % 2.0**b - bias)


def apply_relu(v, i=None, f=None, inv: bool = False, round_mode: str = 'TRN'):
    if isinstance(v, _NUMERIC):
        return relu_float(v, i, f, inv=inv, round_mode=round_mode)
    if inv:
        v = -v
    return v.relu(i, f, round_mode=round_mode)


def apply_quantize(v, k, i, f, round_mode: str = 'TRN', force_wrap: bool = False):
    if isinstance(v, _NUMERIC):
        return quantize_float(v, k, i, f, round_mode=round_mode)
    return v.quantize(k, i, f, round_mode=round_mode, force_wrap=force_wrap)


def numeric_unary_bit_op(a: float, op: int, qint_from: QInterval, qint_to: QInterval | None = None) -> float:
    """op: 0=NOT, 1=OR-reduce(any), 2=AND-reduce(all)."""
    if qint_from.min != 0 or qint_from.max != 0:
        k, i, f = minimal_kif(qint_from)
    else:
        k, i, f = False, 1, 0
    _a = round(a / qint_from.step)
    if op == 0:
        if qint_to is None:
            return _interpret_as(~_a, k, i, f)
        kk, ii, ff = minimal_kif(qint_to)
        return _interpret_as((~_a) % 2 ** (int(k) + i + f), kk, ii, ff)
    if op == 1:
        return float(_a != 0)
    if op == 2:
        if qint_from.min >= 0:
            return float(a == qint_from.max)
        return float(_a == -1)
    raise ValueError(f'Invalid unary bit op {op}')


def numeric_binary_bit_op(a: float, b: float, op: int, qint0: QInterval, qint1: QInterval, qint: QInterval) -> float:
    """op: 0=AND, 1=OR, 2=XOR, applied on the aligned integer representations."""
    fns = {0: lambda x, y: x & y, 1: lambda x, y: x | y, 2: lambda x, y: x ^ y}
    k, i, f = minimal_kif(qint)
    step = min(qint0.step, qint1.step)
    _a, _b = round(a / step), round(b / step)
    return _interpret_as(fns[op](_a, _b), k, i, f)


def apply_unary_bit_op(v, op: int, qint_from: QInterval, qint_to: QInterval | None = None):
    if isinstance(v, _NUMERIC):
        return numeric_unary_bit_op(float(v), op, qint_from, qint_to)
    if op == 0:
        assert qint_to is not None
        return (~v) << round(log2(qint_to.step / qint_from.step))
    return v.unary_bit_op({1: 'any', 2: 'all'}[op])


def apply_binary_bit_op(v0, v1, op: int, qint0: QInterval, qint1: QInterval, qint: QInterval):
    n0, n1 = isinstance(v0, _NUMERIC), isinstance(v1, _NUMERIC)
    if n0 and n1:
        return numeric_binary_bit_op(float(v0), float(v1), op, qint0, qint1, qint)
    if n0:
        v0 = v1.from_const(v0, hwconf=v1.hwconf)
    if n1:
        v1 = v0.from_const(v1, hwconf=v0.hwconf)
    return v0.binary_bit_op(v1, {0: 'and', 1: 'or', 2: 'xor'}[op])
