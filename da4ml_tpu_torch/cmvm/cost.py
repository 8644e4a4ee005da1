"""Hardware cost/latency model for shift-add operations.

``cost_add`` returns (latency_delta, cost) of one adder: bits of accumulation
``n = k + i + f`` of the aligned sum, giving latency ``ceil(n/carry_size)``
(carry-chain delay) and cost ``ceil(n/adder_size)`` (LUT estimate). Size -1
means "one unit regardless" (both -1) / "unbounded" (single -1).

Behavioral parity: reference src/da4ml/_binary/cmvm/state_opr.cc:31-67 and
indexers.cc:36-56 (``overlap_and_accum``).
"""

from __future__ import annotations

from math import ceil, log2

from ..ir.types import QInterval


def cost_add(q0: QInterval, q1: QInterval, shift: int, sub: bool, adder_size: int, carry_size: int) -> tuple[float, float]:
    if adder_size < 0 and carry_size < 0:
        return 1.0, 1.0
    if adder_size < 0:
        adder_size = 65535
    if carry_size < 0:
        carry_size = 65535

    min0, max0, step0 = q0
    min1, max1, step1 = q1
    if sub:
        min1, max1 = max1, min1
    sf = 2.0**shift
    min1, max1, step1 = min1 * sf, max1 * sf, step1 * sf
    max0 += step0
    max1 += step1

    f = -log2(max(step0, step1))
    i = ceil(log2(max(abs(min0), abs(min1), abs(max0), abs(max1))))
    k = 1 if (q0.min < 0 or q1.min < 0) else 0
    n_accum = k + i + f
    return float(ceil(n_accum / carry_size)), float(ceil(n_accum / adder_size))


def _iceil_log2(x: float) -> int:
    return int(ceil(log2(x))) if x > 0 else 0


def overlap_and_accum(q0: QInterval, q1: QInterval) -> tuple[int, int]:
    """(n_overlap, n_accum) bit counts used by the wmc scoring heuristic."""
    min0, max0, step0 = q0
    min1, max1, step1 = q1
    max0 += step0
    max1 += step1
    f = -_iceil_log2(max(step0, step1))
    i_high = _iceil_log2(max(abs(min0), abs(min1), abs(max0), abs(max1)))
    i_low = _iceil_log2(min(max(abs(min0), abs(max0)), max(abs(min1), abs(max1))))
    k = 1 if (q0.min < 0 or q1.min < 0) else 0
    return k + i_low + f, k + i_high + f
