"""Stage-1 graph decomposition: W = W1 @ W2 via a Prim MST over columns.

Columns of the (centered) kernel are graph vertices plus a zero root; the
edge weight between two columns is the CSD Hamming weight of their difference
or sum (whichever is smaller). The MST edges become the columns of W1; W2
records how they recombine into the original columns.

Behavioral parity: reference src/da4ml/_binary/cmvm/mat_decompose.cc and
docs/cmvm.md:9-17.
"""

from __future__ import annotations

import numpy as np
from numpy.typing import NDArray

from .csd import center, int_arr_to_csd

_INF = np.int64(2**62)


def prim_mst_dc(cost_mat: NDArray[np.int64], dc: int) -> NDArray[np.int32]:
    """Prim's MST from root 0, optionally latency(depth)-constrained by ``dc``.

    Returns edge list [(parent, child)] in insertion order.
    Parity: mat_decompose.cc:6-60.
    """
    n = cost_mat.shape[0]
    lat_mat = np.ceil(np.log2(np.maximum(cost_mat, 1).astype(np.float64)))
    parent = np.full(n, -2, dtype=np.int64)
    parent[0] = -1
    latency = np.zeros(n, dtype=np.int64)
    mapping = np.empty((n - 1, 2), dtype=np.int32)

    _dc = -1.0
    if dc >= 0:
        max_cost0 = float(cost_mat[0].max())
        _dc = (2.0**dc - 1) + np.ceil(np.log2(max_cost0 + 1e-32))

    for n_impl in range(1, n):
        impl = np.flatnonzero(parent != -2)
        not_impl = np.flatnonzero(parent == -2)
        sub = cost_mat[np.ix_(not_impl, impl)].copy()
        if dc >= 0:
            max_lat = np.maximum(lat_mat[np.ix_(not_impl, impl)], latency[impl][None, :]) + 1
            sub = np.where(max_lat > _dc, _INF // 2, sub)
        flat = int(np.argmin(sub))
        bi, bj = divmod(flat, len(impl))
        i, j = int(not_impl[bi]), int(impl[bj])
        parent[i] = j
        mapping[n_impl - 1, 0] = j
        mapping[n_impl - 1, 1] = i
        latency[i] = int(max(lat_mat[i, j], latency[j]) + 1)
    return mapping


def kernel_decompose(kernel: NDArray, dc: int) -> tuple[NDArray[np.float64], NDArray[np.float64]]:
    """Decompose ``kernel`` into (m0, m1) with ``m0 @ m1 == kernel``.

    ``dc == -1`` returns the identity split. Parity: mat_decompose.cc:62-137.
    """
    kernel = np.array(kernel, dtype=np.float64)
    centered, shift0, shift1 = center(kernel)
    scale0 = 2.0 ** shift0.astype(np.float64)
    scale1 = 2.0 ** shift1.astype(np.float64)
    n_in, n_out = centered.shape

    if dc == -1:
        return centered * scale0[:, None], np.eye(n_out) * scale1

    # augmented with zero root column at index 0
    mat_aug = np.zeros((n_in, n_out + 1))
    mat_aug[:, 1:] = centered

    diff0 = mat_aug[:, :, None] - mat_aug[:, None, :]
    diff1 = mat_aug[:, :, None] + mat_aug[:, None, :]
    csd0 = int_arr_to_csd(diff0.astype(np.int64))
    csd1 = int_arr_to_csd(diff1.astype(np.int64))
    dist0 = (csd0 != 0).sum(axis=(0, 3)).astype(np.int64)
    dist1 = (csd1 != 0).sum(axis=(0, 3)).astype(np.int64)
    sign_arr = np.where(dist1 - dist0 < 0, -1, 1).astype(np.int64)
    dist = np.minimum(dist0, dist1)

    mapping = prim_mst_dc(dist, dc)

    m0 = np.zeros((n_in, n_out))
    m1 = np.zeros((n_out, n_out))
    cnt = 0
    for k in range(mapping.shape[0]):
        _from, _to = int(mapping[k, 0]), int(mapping[k, 1])
        col0 = mat_aug[:, _to] - mat_aug[:, _from] * sign_arr[_to, _from]
        if _from != 0:
            col1 = m1[:, _from - 1] * sign_arr[_to, _from]
        else:
            col1 = np.zeros(n_out)
        if np.any(col0 != 0):
            col1 = col1.copy()
            col1[cnt] = 1.0
            m0[:, cnt] = col0
            cnt += 1
        m1[:, _to - 1] = col1
    return m0 * scale0[:, None], m1 * scale1
