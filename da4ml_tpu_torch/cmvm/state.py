"""Greedy CSE state for the distributed-arithmetic CMVM optimizer.

State = per-input sparse CSD expressions (``expr[i].rows[i_out]`` holds digits
encoded as ``sign * (shift + 1)``), a frequency map of two-term candidate
subexpressions ``a ± (b << s)``, and the growing op list. One CSE iteration
substitutes the chosen pair everywhere and incrementally recounts pairs
touching the modified rows.

Behavioral parity: reference src/da4ml/_binary/cmvm/{types.hh,state_opr.cc}.
The freq map is kept as a dict but *iterated in the reference's sorted Pair
order* (id1, id0, sub, shift) so heuristic tie-breaking matches exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
from numpy.typing import NDArray

from ..ir.types import Op, QInterval, qint_add
from .cost import cost_add
from .csd import csd_decompose


class Pair(NamedTuple):
    """Candidate subexpression ``buf[id0] ± (buf[id1] << shift)`` (id0 <= id1)."""

    id0: int
    id1: int
    sub: bool
    shift: int

    @property
    def sort_key(self):
        return (self.id1, self.id0, self.sub, self.shift)


def to_shift(v: int) -> int:
    return abs(v) - 1


def to_sign(v: int) -> int:
    return 1 if v > 0 else -1


def encode_digit(shift: int, sign: int) -> int:
    return sign * (shift + 1)


def make_pair(id0: int, id1: int, v0: int, v1: int) -> Pair:
    assert id0 <= id1, 'id0 must be <= id1'
    sub = to_sign(v0) != to_sign(v1)
    return Pair(id0, id1, sub, to_shift(v1) - to_shift(v0))


@dataclass
class DAState:
    shift0: NDArray[np.int8]
    shift1: NDArray[np.int8]
    expr: list[list[list[int]]]  # expr[i_in][i_out] -> list of encoded digits
    n_bits: int
    ops: list[Op]
    freq_stat: dict[Pair, int]
    kernel: NDArray[np.float64]
    n_out: int = field(default=0)
    #: ``freq_stat.items()`` in the reference scan order (Pair.sort_key asc),
    #: maintained incrementally by :func:`update_stats` — heuristics consult
    #: this instead of re-sorting the whole map on every selection call.
    #: ``None`` means stale/unbuilt (the next selection sorts and caches).
    sorted_stat: list[tuple[Pair, int]] | None = field(default=None, repr=False, compare=False)


def _count_pairs_into(stat: dict[Pair, int], raw: list[Pair]) -> None:
    """Count raw pairs; only pairs occurring >= 2 times are kept (types.hh:73-95)."""
    counts: dict[Pair, int] = {}
    for p in raw:
        counts[p] = counts.get(p, 0) + 1
    for p, c in counts.items():
        if c >= 2:
            stat[p] = c


def _row_pairs(raw: list[Pair], lo: int, hi: int, row_lo: list[int], row_hi: list[int]) -> None:
    if not row_lo or not row_hi:
        return
    if lo == hi:
        for a in range(1, len(row_lo)):
            va = row_lo[a]
            for b in range(a):
                raw.append(make_pair(lo, lo, va, row_lo[b]))
    else:
        for v0 in row_lo:
            for v1 in row_hi:
                raw.append(make_pair(lo, hi, v0, v1))


def create_state(
    kernel: NDArray,
    qintervals: list[QInterval],
    inp_latencies: list[float],
    no_stat_init: bool = False,
) -> DAState:
    """Build the initial CSE state from a constant kernel (state_opr.cc:79-159)."""
    kernel = np.array(kernel, dtype=np.float64)
    n_in, n_out = kernel.shape
    csd, shift0, shift1 = csd_decompose(kernel)

    for i in range(n_in):
        if qintervals[i].min == 0.0 and qintervals[i].max == 0.0:
            csd[i] = 0

    n_bits = csd.shape[2]
    expr: list[list[list[int]]] = []
    for i in range(n_in):
        rows: list[list[int]] = []
        for io in range(n_out):
            digits = [encode_digit(j, int(v)) for j, v in enumerate(csd[i, io]) if v != 0]
            rows.append(digits)
        expr.append(rows)

    stat: dict[Pair, int] = {}
    if not no_stat_init:
        raw: list[Pair] = []
        for i_out in range(n_out):
            for i0 in range(n_in):
                for i1 in range(i0, n_in):
                    _row_pairs(raw, i0, i1, expr[i0][i_out], expr[i1][i_out])
        _count_pairs_into(stat, raw)

    # Input-op qints are scaled by the factored-out row shifts so the recorded
    # interval matches the actual buffer content (inp * 2**shift0). The
    # reference keeps nominal intervals here (state_opr.cc:146-149), which is
    # only sound for symbolic replay, not direct DAIS execution.
    ops = []
    for i in range(n_in):
        sf = 2.0 ** float(shift0[i])
        q = qintervals[i]
        ops.append(Op(i, -1, -1, 0, QInterval(q.min * sf, q.max * sf, q.step * sf), inp_latencies[i], 0.0))
    return DAState(
        shift0=shift0,
        shift1=shift1,
        expr=expr,
        n_bits=n_bits,
        ops=ops,
        freq_stat=stat,
        kernel=kernel,
        n_out=n_out,
    )


def pair_to_op(pair: Pair, state: DAState, adder_size: int, carry_size: int) -> Op:
    dlat, cost = cost_add(state.ops[pair.id0].qint, state.ops[pair.id1].qint, pair.shift, pair.sub, adder_size, carry_size)
    lat = max(state.ops[pair.id0].latency, state.ops[pair.id1].latency) + dlat
    qint = qint_add(state.ops[pair.id0].qint, state.ops[pair.id1].qint, pair.shift, False, pair.sub)
    return Op(pair.id0, pair.id1, int(pair.sub), pair.shift, qint, lat, cost)


def update_expr(state: DAState, pair: Pair, adder_size: int, carry_size: int) -> None:
    """Substitute the chosen pair: remove matched digit pairs from the operand
    rows, append a new expr slice holding the surviving anchor digits
    (state_opr.cc:227-283)."""
    op = pair_to_op(pair, state, adder_size, carry_size)
    state.ops.append(op)

    id0, id1, sub, rel_shift = pair.id0, pair.id1, pair.sub, pair.shift
    flip = False
    if rel_shift < 0:
        id0, id1 = id1, id0
        rel_shift = -rel_shift
        flip = True
    target_sign = -1 if sub else 1

    new_slice: list[list[int]] = [[] for _ in range(state.n_out)]
    for i_out in range(state.n_out):
        row0 = state.expr[id0][i_out]
        row1 = state.expr[id1][i_out]
        for loc0 in range(len(row0)):
            v0 = row0[loc0]
            if v0 == 0:
                continue
            s0, g0 = to_shift(v0), to_sign(v0)
            s1 = s0 + rel_shift
            if s1 >= state.n_bits:
                continue
            loc1 = next((j for j, v in enumerate(row1) if to_shift(v) == s1), -1)
            g1 = to_sign(row1[loc1]) if loc1 >= 0 else 0
            if target_sign * g1 * g0 != 1:
                continue
            if not flip:
                new_slice[i_out].append(encode_digit(s0, g0))
            else:
                new_slice[i_out].append(encode_digit(s1, g1))
            row0[loc0] = 0
            row1[loc1] = 0
        state.expr[id0][i_out] = [v for v in row0 if v != 0]
        if id0 != id1:
            state.expr[id1][i_out] = [v for v in state.expr[id1][i_out] if v != 0]
    state.expr.append(new_slice)


def update_stats(state: DAState, pair: Pair) -> None:
    """Purge freq entries touching the modified rows, regenerate, batch-merge
    (state_opr.cc:285-345).

    The sorted scan-order view (``state.sorted_stat``) is maintained
    incrementally alongside: survivors of the purge keep their relative
    order, regenerated pairs all touch a modified row (so they can never
    collide with a survivor), and one ``heapq.merge`` of the two sorted runs
    replaces the full re-sort the selection heuristics used to pay per call.
    """
    id0, id1 = pair.id0, pair.id1
    dirty = {id0, id1}
    survivors: list[tuple[Pair, int]] | None = None
    if state.sorted_stat is not None and len(state.sorted_stat) == len(state.freq_stat):
        survivors = [kv for kv in state.sorted_stat if kv[0].id0 not in dirty and kv[0].id1 not in dirty]
    state.freq_stat = {p: c for p, c in state.freq_stat.items() if not (p.id0 in dirty or p.id1 in dirty)}

    n_constructed = len(state.expr)
    modified = [n_constructed - 1, id0] + ([id1] if id0 != id1 else [])

    raw: list[Pair] = []
    for i_out in range(state.n_out):
        for _in1 in range(n_constructed):
            for _in0 in modified:
                if (_in1 == n_constructed - 1 or _in1 == id0 or _in1 == id1) and _in0 > _in1:
                    continue
                lo, hi = min(_in0, _in1), max(_in0, _in1)
                _row_pairs(raw, lo, hi, state.expr[lo][i_out], state.expr[hi][i_out])
    fresh: dict[Pair, int] = {}
    _count_pairs_into(fresh, raw)
    state.freq_stat.update(fresh)
    if survivors is not None:
        from heapq import merge

        fresh_sorted = sorted(fresh.items(), key=lambda kv: kv[0].sort_key)
        state.sorted_stat = list(merge(survivors, fresh_sorted, key=lambda kv: kv[0].sort_key))
    else:
        state.sorted_stat = None


def update_state(state: DAState, pair: Pair, adder_size: int, carry_size: int) -> None:
    update_expr(state, pair, adder_size, carry_size)
    update_stats(state, pair)
