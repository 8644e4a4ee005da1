"""Hardware sorting networks: compare-swap cells built from MSB muxes.

The network is built as *data* first — a list of ``(i, j, up)`` comparator
cells — and then applied to the symbolic rows, so the wiring (Batcher
odd-even mergesort by default, bitonic optionally) is decoupled from the
cell implementation. Non-pow2 lengths are padded with out-of-range
sentinels; an optional payload (``aux_value``) rides along with each key
for argsort-style gathers.

Counterpart of ``da4ml_tpu/trace/ops/sorting.py``; the networks are the same.
"""

from __future__ import annotations

from functools import lru_cache
from math import ceil, log2

import numpy as np

from ..fixed_variable import FixedVariable


@lru_cache(maxsize=None)
def _batcher_network(n: int) -> tuple[tuple[int, int, bool], ...]:
    """Comparator list for Batcher's odd-even mergesort of ``n`` (pow2) wires."""
    cells: list[tuple[int, int, bool]] = []

    def merge(lo: int, hi: int, stride: int) -> None:
        # merge the two sorted halves of wires lo..hi taken at ``stride``
        step = stride * 2
        if step < hi - lo:
            merge(lo, hi, step)
            merge(lo + stride, hi, step)
            for w in range(lo + stride, hi - stride, step):
                cells.append((w, w + stride, True))
        else:
            cells.append((lo, lo + stride, True))

    def build(lo: int, hi: int) -> None:
        if hi - lo >= 1:
            mid = lo + (hi - lo) // 2
            build(lo, mid)
            build(mid + 1, hi)
            merge(lo, hi, 1)

    build(0, n - 1)
    return tuple(cells)


@lru_cache(maxsize=None)
def _bitonic_network(n: int) -> tuple[tuple[int, int, bool], ...]:
    """Comparator list for a bitonic sort of ``n`` (pow2) wires."""
    cells: list[tuple[int, int, bool]] = []

    def merge(lo: int, span: int, up: bool) -> None:
        if span == 1:
            return
        half = span // 2
        for w in range(lo, lo + half):
            cells.append((w, w + half, up))
        merge(lo, half, up)
        merge(lo + half, half, up)

    def build(lo: int, span: int, up: bool) -> None:
        if span == 1:
            return
        half = span // 2
        build(lo, half, True)
        build(lo + half, half, False)
        merge(lo, span, up)

    build(0, n, True)
    return tuple(cells)


def _apply_cell(rows, i: int, j: int, up: bool) -> None:
    """One comparator: after this, key(rows[i]) <= key(rows[j]) iff ``up``.

    The swap condition is a single comparison of the keys (column 0); every
    column of both rows is then routed through an MSB mux pair on that
    condition, so payload columns travel with their key. Tie behavior matches
    the reference cell: equal keys hold position in an up cell and exchange
    in a down cell.
    """
    top, bot = rows[i], rows[j]
    swap = (top[0] > bot[0]) if up else (top[0] <= bot[0])
    n_col = len(top)
    new_top = np.empty(n_col, dtype=object)
    new_bot = np.empty(n_col, dtype=object)
    for c in range(n_col):
        new_top[c] = swap.msb_mux(bot[c], top[c], zt_sensitive=False)
        new_bot[c] = swap.msb_mux(top[c], bot[c], zt_sensitive=False)
    rows[i], rows[j] = new_top, new_bot


_NETWORKS = {'batcher': _batcher_network, 'bitonic': _bitonic_network}


def _pad_to_pow2(a):
    """Pad the sort axis to a power of two with below-min / above-max sentinels."""
    assert a.ndim == 3
    size = a.shape[-2]
    n_pad = 2 ** ceil(log2(size)) - size
    n_low, n_high = n_pad // 2, n_pad - n_pad // 2
    low, high, _ = a.lhs
    below = FixedVariable.from_const(float(np.min(low)) - 1, hwconf=a.hwconf)
    above = FixedVariable.from_const(float(np.max(high)) + 1, hwconf=a.hwconf)
    low_block = np.full((a.shape[0], n_low, a.shape[-1]), below)
    high_block = np.full((a.shape[0], n_high, a.shape[-1]), above)
    return np.concatenate([low_block, a, high_block], axis=-2), n_low, n_high


def sort(a, axis: int | None = None, kind: str = 'batcher', aux_value=None):
    from ..fixed_variable_array import FixedVariableArray  # noqa: F401  (type anchor)

    if isinstance(a, np.ndarray):
        return np.sort(a, axis=axis)
    if axis is None:
        axis = -1
    axis = axis % a.ndim

    if aux_value is not None:
        assert a.ndim == 1, f'aux_value requires 1D keys, got a.ndim={a.ndim}'
        assert a.shape[0] == aux_value.shape[0], f'length mismatch: {a.shape} vs {aux_value.shape}'
        if aux_value.shape == a.shape:
            aux_value = aux_value[..., None]
        assert aux_value.ndim - a.ndim == 1 and aux_value.shape[:-1] == a.shape
        a = np.concatenate([a[..., None], aux_value], axis=-1)
    else:
        a = a[..., None]

    sort_dim = a.shape[axis]
    r = np.moveaxis(a, axis, -2).copy()
    shape = r.shape
    r = r.reshape(-1, sort_dim, r.shape[-1])
    r, n_low, n_high = _pad_to_pow2(r)

    try:
        network = _NETWORKS[kind.lower()](r.shape[1])
    except KeyError:
        raise ValueError(f'Unsupported sorting algorithm: {kind}') from None
    for lane in range(len(r)):
        rows = list(r._vars[lane])
        for i, j, up in network:
            _apply_cell(rows, i, j, up)
        for i, row in enumerate(rows):
            r._vars[lane, i] = row

    r = r[:, n_low : r.shape[1] - n_high, :].reshape(shape)
    r = np.moveaxis(r, -2, axis)
    if aux_value is not None:
        return r[..., 0], r[..., 1:]
    assert r.shape[-1] == 1
    return r[..., 0]
