"""Balanced reductions producing latency-optimal adder trees.

A reduction over symbolic fixed-point values is scheduled like a job queue:
every value gets a readiness rank, and the two lowest-ranked values are
combined first, with the merged value re-entering the queue at its own rank.
The rank and its tie order fix the emitted tree op for op.

Combination order never changes the numeric result: fixed-point adds are
exact, so only cost/latency of the emitted tree depends on the schedule.

Counterpart of ``da4ml_tpu/trace/ops/reduce_utils.py``; the trees are the same.
"""

from __future__ import annotations

import heapq
from collections.abc import Callable, Sequence
from functools import reduce as _fold
from math import prod

import numpy as np

from ..fixed_variable import FixedVariable

#: rank for non-symbolic operands: merge before any symbolic value
_EAGER_RANK = (-1.0, 0, 0)


def _merge_rank(v) -> tuple[float, int, int]:
    """Scheduling rank: earlier-ready, negative-factor, narrower merge first.

    Latency dominates so a freshly merged value (whose latency is the max of
    its operands plus the add delay) sinks behind still-unmerged cheap leaves;
    negative-factor values merge first so subtractions fold into the tree
    early (the reference packet order); the k+i width keeps accumulator
    growth balanced across the tree.
    """
    if not isinstance(v, FixedVariable):
        return _EAGER_RANK
    kif = v.kif
    return (v.latency, int(v._factor > 0), kif[0] + kif[1])


def _reduce(operator: Callable, items: Sequence):
    """Combine ``items`` pairwise, cheapest-rank first."""
    if isinstance(items, np.ndarray):
        items = list(items.ravel())
    if not items:
        raise ValueError('cannot reduce an empty sequence')
    if len(items) == 1:
        return items[0]
    if not isinstance(items[0], FixedVariable):
        return _fold(operator, items)

    # (rank, seq, value): seq makes ties deterministic (FIFO) and keeps the
    # heap from ever comparing two FixedVariables directly
    queue = [(_merge_rank(v), n, v) for n, v in enumerate(items)]
    heapq.heapify(queue)
    seq = len(items)
    while len(queue) > 1:
        a = heapq.heappop(queue)[2]
        b = heapq.heappop(queue)[2]
        merged = operator(a, b)
        heapq.heappush(queue, (_merge_rank(merged), seq, merged))
        seq += 1
    return queue[0][2]


def reduce(operator: Callable, x, axis=None, keepdims: bool = False):
    """Reduce over the given axes with balanced (heap) combination order."""
    from ..fixed_variable_array import FixedVariableArray

    wrapped = isinstance(x, FixedVariableArray)
    arr = x._vars if wrapped else x

    ndim = arr.ndim

    def _norm(a: int) -> int:
        if not -ndim <= a < ndim:
            raise np.exceptions.AxisError(a, ndim)
        return a % ndim

    if axis is None:
        red_axes = set(range(ndim))
    elif isinstance(axis, int):
        red_axes = {_norm(axis)}
    else:
        red_axes = {_norm(a) for a in axis}

    # move reduced axes to the back (stable among kept / among reduced),
    # then every row of the flattened view is one independent reduction
    order = [a for a in range(ndim) if a not in red_axes] + [a for a in range(ndim) if a in red_axes]
    n_red = prod(arr.shape[a] for a in red_axes)
    rows = np.transpose(arr, order).reshape(-1, n_red)
    out = np.array([_reduce(operator, row) for row in rows])

    if keepdims:
        shape = tuple(1 if a in red_axes else d for a, d in enumerate(arr.shape))
    else:
        shape = tuple(d for a, d in enumerate(arr.shape) if a not in red_axes)
    out = out.reshape(shape)

    if wrapped:
        res = FixedVariableArray(out, x.solver_options, hwconf=x.hwconf)
        return res._vars.item() if res.shape == () else res
    return out if out.shape != () or keepdims else out.item()
