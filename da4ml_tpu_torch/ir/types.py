"""Core IR atoms of the DAIS (Distributed Arithmetic Instruction Set) program.

A program is a flat SSA op list over an integer buffer; every op annotates its
result with a quantization interval (``QInterval``) from which the minimal
fixed-point type (``Precision`` = keep_negative / integer / fractional bits)
is derived.

Counterpart of ``da4ml_tpu/ir/types.py``; the port keeps its own copy.
"""

from __future__ import annotations

from math import ceil, floor, isfinite, log2
from typing import NamedTuple

import numpy as np


class QInterval(NamedTuple):
    """Closed interval [min, max] of representable values with uniform step.

    ``step`` must be a power of two. The minimal fixed-point container of the
    interval is given by :func:`minimal_kif`.
    """

    min: float
    max: float
    step: float


class Precision(NamedTuple):
    """Fixed-point format: sign bit flag, integer bits (excl. sign), fractional bits."""

    keep_negative: bool
    integers: int
    fractional: int

    @property
    def width(self) -> int:
        return int(self.keep_negative) + self.integers + self.fractional


class Op(NamedTuple):
    """One SSA operation filling one slot of the execution buffer.

    opcode semantics (DAIS v1):
      -1      copy from input buffer (implies quantization)
      0 / 1   buf[id0] +/- buf[id1] * 2**data
      2 / -2  quantize(relu(+/- buf[id0]))
      3 / -3  quantize(+/- buf[id0])
      4       buf[id0] + data * qint.step
      5       constant definition: data * qint.step
      6 / -6  MSB mux: msb(buf[data_lo]) ? buf[id0] : (+/- buf[id1]) << data_hi
      7       buf[id0] * buf[id1]
      8       lookup_tables[data_lo][index(buf[id0])]
      9 / -9  unary bitwise on (+/- buf[id0]); data: 0=NOT, 1=OR-reduce, 2=AND-reduce
      10      binary bitwise; data packs subop[63:56], neg1[33], neg0[32], shift[31:0]
    """

    id0: int
    id1: int
    opcode: int
    data: int
    qint: QInterval
    latency: float
    cost: float


def minimal_kif(qi: QInterval, symmetric: bool = False) -> Precision:
    """Minimal fixed-point format (keep_negative, integers, fractional) holding ``qi``."""
    if qi.min == qi.max == 0:
        return Precision(False, 0, 0)
    keep_negative = qi.min < 0
    step = float(qi.step)
    # a silent int(log2(...)) here would truncate a corrupt step into a wrong
    # format; every non-zero interval must carry a positive power-of-two step
    if not (step > 0.0 and isfinite(step)):
        raise ValueError(f'QInterval.step must be a positive power of two, got {step!r} in {qi}')
    f_exact = -log2(step)
    fractional = int(round(f_exact))
    if f_exact != fractional:
        raise ValueError(f'QInterval.step must be a positive power of two, got {step!r} in {qi}')
    int_min, int_max = round(qi.min / qi.step), round(qi.max / qi.step)
    if symmetric:
        bits = int(ceil(log2(max(abs(int_min), int_max) + 1)))
    else:
        bits = int(ceil(log2(max(abs(int_min), int_max + 1))))
    return Precision(keep_negative, bits - fractional, fractional)


def quantize_float(v, k: int | bool, i: int, f: int, round_mode: str = 'TRN'):
    """Fixed-point quantization of float value(s): WRAP overflow, TRN/RND rounding."""
    v = np.asarray(v, dtype=np.float64)
    if round_mode.upper() == 'RND':
        v = v + 2.0 ** (-f - 1)
    b = int(k) + i + f
    bias = 2.0 ** (b - 1) * int(k)
    eps = 2.0**-f
    return eps * ((np.floor(v / eps) + bias) % 2**b - bias)


def relu_float(v, i: int | None = None, f: int | None = None, inv: bool = False, round_mode: str = 'TRN'):
    """relu followed by optional (i, f) quantization (TRN/RND rounding, WRAP)."""
    if inv:
        v = -v
    v = max(0.0, v)
    if f is not None:
        if round_mode.upper() == 'RND':
            v += 2.0 ** (-f - 1)
        sf = 2.0**f
        v = floor(v * sf) / sf
    if i is not None:
        v = v % 2.0**i
    return v


def qint_scale(qi: QInterval, scale: float) -> QInterval:
    """Scale a QInterval by a (power-of-two) factor, preserving orientation."""
    lo, hi = qi.min * scale, qi.max * scale
    if scale < 0:
        lo, hi = hi, lo
    return QInterval(lo, hi, abs(qi.step * scale))


def qint_neg(qi: QInterval) -> QInterval:
    return QInterval(-qi.max, -qi.min, qi.step)


def qint_add(q0: QInterval, q1: QInterval, shift: int, sub0: bool, sub1: bool) -> QInterval:
    """Interval of ``(+/-q0) + (+/-q1) * 2**shift``."""
    min0, max0 = (-q0.max, -q0.min) if sub0 else (q0.min, q0.max)
    min1, max1 = (-q1.max, -q1.min) if sub1 else (q1.min, q1.max)
    s = 2.0**shift
    return QInterval(min0 + min1 * s, max0 + max1 * s, min(q0.step, q1.step * s))
