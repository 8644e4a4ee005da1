"""CMVM core: the greedy CSE loop and adder-tree emission.

``cmvm`` runs the iterative subexpression elimination until the frequency map
drains; ``to_solution`` turns the residual sparse expressions into balanced
shift-add reduction trees per output (min-heap keyed on latency, so the trees
are latency-optimal), producing a ``CombLogic``.

Behavioral parity: reference src/da4ml/_binary/cmvm/cmvm_core.cc.
"""

from __future__ import annotations

import heapq
from math import log2

import numpy as np
from numpy.typing import NDArray

from ..ir.comb import CombLogic
from ..ir.types import Op, QInterval, qint_add
from .cost import cost_add
from .heuristics import select_pair
from .state import DAState, create_state, to_shift, to_sign, update_state


def cmvm(
    kernel: NDArray,
    method: str,
    qintervals: list[QInterval] | None = None,
    inp_latencies: list[float] | None = None,
    adder_size: int = -1,
    carry_size: int = -1,
) -> DAState:
    kernel = np.asarray(kernel, dtype=np.float64)
    n_in = kernel.shape[0]
    if not qintervals:
        qintervals = [QInterval(-128.0, 127.0, 1.0)] * n_in
    if not inp_latencies:
        inp_latencies = [0.0] * n_in

    state = create_state(kernel, qintervals, inp_latencies, no_stat_init=method == 'dummy')
    while state.freq_stat:
        pair = select_pair(state, method)
        if pair.id0 == -1 or pair.id1 == -1:
            break
        update_state(state, pair, adder_size, carry_size)
    return state


def _left_align(qint: QInterval, shift: int) -> int:
    return int(log2(max(abs(qint.max + qint.step), abs(qint.min)))) + shift


def to_solution(state: DAState, adder_size: int, carry_size: int) -> CombLogic:
    """Emit the balanced reduction trees for each output column (cmvm_core.cc:89-225)."""
    ops = list(state.ops)
    n_out = state.n_out
    n_expr = len(state.expr)

    out_idxs: list[int] = []
    out_shifts: list[int] = []
    out_negs: list[int] = []
    inp_shifts = [int(v) for v in state.shift0]
    out_shifts_base = [int(v) for v in state.shift1]

    _global_id = len(ops)

    for i_out in range(n_out):
        idx: list[int] = []
        shifts: list[int] = []
        subs: list[int] = []
        for i_in in range(n_expr):
            for v in state.expr[i_in][i_out]:
                idx.append(i_in)
                shifts.append(to_shift(v))
                subs.append(1 if to_sign(v) == -1 else 0)

        if len(idx) == 1:
            out_shifts.append(out_shifts_base[i_out] + shifts[0])
            out_idxs.append(idx[0])
            out_negs.append(subs[0])
            continue
        if not idx:
            out_idxs.append(-1)
            out_shifts.append(out_shifts_base[i_out])
            out_negs.append(0)
            continue

        # heap entries ordered by (lat, sub, left_align, qmin, qmax, qstep, id, shift)
        heap = []
        for k in range(len(idx)):
            qint = ops[idx[k]].qint
            lat = ops[idx[k]].latency
            heap.append((lat, subs[k], _left_align(qint, shifts[k]), qint.min, qint.max, qint.step, idx[k], shifts[k]))
        heapq.heapify(heap)

        while len(heap) > 1:
            lat0, sub0, _, qmin0, qmax0, qstep0, id0, shift0 = heapq.heappop(heap)
            lat1, sub1, _, qmin1, qmax1, qstep1, id1, shift1 = heapq.heappop(heap)
            qint0 = QInterval(qmin0, qmax0, qstep0)
            qint1 = QInterval(qmin1, qmax1, qstep1)

            if sub0:
                s = shift0 - shift1
                qint = qint_add(qint1, qint0, s, bool(sub1), bool(sub0))
                dlat, dcost = cost_add(qint1, qint0, s, bool(1 ^ sub1), adder_size, carry_size)
                lat = max(lat0, lat1) + dlat
                op = Op(id1, id0, 1 ^ sub1, s, qint, lat, dcost)
                result_shift = shift1
            else:
                s = shift1 - shift0
                qint = qint_add(qint0, qint1, s, bool(sub0), bool(sub1))
                dlat, dcost = cost_add(qint0, qint1, s, bool(sub1), adder_size, carry_size)
                lat = max(lat0, lat1) + dlat
                op = Op(id0, id1, sub1, s, qint, lat, dcost)
                result_shift = shift0

            heapq.heappush(
                heap,
                (op.latency, sub0 & sub1, _left_align(qint, result_shift), qint.min, qint.max, qint.step, _global_id, result_shift),
            )
            ops.append(op)
            _global_id += 1

        final = heap[0]
        out_idxs.append(_global_id - 1)
        out_negs.append(final[1])
        out_shifts.append(out_shifts_base[i_out] + final[7])

    return CombLogic(
        shape=(state.kernel.shape[0], n_out),
        inp_shifts=inp_shifts,
        out_idxs=out_idxs,
        out_shifts=out_shifts,
        out_negs=[bool(v) for v in out_negs],
        ops=ops,
        carry_size=carry_size,
        adder_size=adder_size,
    )


def solve_single(
    kernel: NDArray,
    method: str,
    qintervals: list[QInterval] | None = None,
    latencies: list[float] | None = None,
    adder_size: int = -1,
    carry_size: int = -1,
) -> CombLogic:
    state = cmvm(kernel, method, qintervals, latencies, adder_size, carry_size)
    return to_solution(state, adder_size, carry_size)
